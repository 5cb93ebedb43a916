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
from repro_torch.store.vector_store import InMemoryRecordStore

__all__ = [
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
    "InMemoryRecordStore",
]
