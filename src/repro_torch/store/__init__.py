from repro_torch.store.disk import DiskRecordStore, ReadDeadlineError, RetryPolicy, is_transient
from repro_torch.store.faults import FaultInjector, FaultPlan
from repro_torch.store.format import (
    FORMAT_VERSION,
    PAGE_BYTES,
    SEGMENT_MAGIC,
    IndexFile,
    IndexFormatError,
    IndexHeader,
    read_header,
    read_index,
    read_segment_header,
    record_sector_bytes,
    write_index,
)
from repro_torch.store.vector_store import HostOffloadRecordStore, InMemoryRecordStore

__all__ = [
    "DiskRecordStore",
    "ReadDeadlineError",
    "RetryPolicy",
    "is_transient",
    "FaultInjector",
    "FaultPlan",
    "FORMAT_VERSION",
    "PAGE_BYTES",
    "SEGMENT_MAGIC",
    "IndexFile",
    "IndexFormatError",
    "IndexHeader",
    "read_header",
    "read_index",
    "read_segment_header",
    "record_sector_bytes",
    "write_index",
    "HostOffloadRecordStore",
    "InMemoryRecordStore",
]
