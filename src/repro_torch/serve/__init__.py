"""Retrieval serving: ``RAGServer.retrieve`` and the multi-tenant
``ServeFrontend``.

The reference's LM-side names (``make_serve_step``, ``make_prefill_step``,
``cache_pspecs``, ``RAGServer.generate``) come with the port's LM side.
"""
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
