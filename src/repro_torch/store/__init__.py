from repro_torch.store.adaptive import ADAPTIVE_POLICY, AdaptiveRecordCache, filter_bucket
from repro_torch.store.cache import (
    CACHE_POLICIES,
    CachedRecordStore,
    bfs_hot_set,
    record_nbytes,
    select_hot_set,
    visit_freq_hot_set,
)
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
from repro_torch.store.vector_store import (
    HostOffloadRecordStore,
    InMemoryRecordStore,
    ShardedRecordStore,
    is_lazy_host,
)

__all__ = [
    "ADAPTIVE_POLICY",
    "AdaptiveRecordCache",
    "filter_bucket",
    "CACHE_POLICIES",
    "CachedRecordStore",
    "bfs_hot_set",
    "record_nbytes",
    "select_hot_set",
    "visit_freq_hot_set",
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
    "ShardedRecordStore",
    "is_lazy_host",
]
