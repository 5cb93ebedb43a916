"""Serving: the LM's prefill and decode steps, ``RAGServer`` (retrieval
and generation) and the multi-tenant ``ServeFrontend``; ``cache_pspecs``
plans the caches' sharding under a layout.
"""
from repro_torch.serve.decode import cache_pspecs, make_serve_step
from repro_torch.serve.prefill import make_prefill_step
from repro_torch.serve.rag import RAGRequest, RAGServer
from repro_torch.serve.server import (
    FAULT_POLICIES,
    AdmissionError,
    DeadlineExceeded,
    RequestTrace,
    ServeFrontend,
    ServeHandle,
    ServerClosed,
    TenantSpec,
)

__all__ = [
    "cache_pspecs",
    "make_serve_step",
    "make_prefill_step",
    "RAGRequest",
    "RAGServer",
    "ServeFrontend",
    "TenantSpec",
    "ServeHandle",
    "RequestTrace",
    "AdmissionError",
    "ServerClosed",
    "DeadlineExceeded",
    "FAULT_POLICIES",
]
