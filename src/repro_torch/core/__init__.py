from repro_torch.core.engine import EngineConfig, GateANNEngine, recall_at_k
from repro_torch.core.search import SearchConfig, SearchOutput, SearchStats, filtered_search

__all__ = [
    "EngineConfig",
    "GateANNEngine",
    "recall_at_k",
    "SearchConfig",
    "SearchOutput",
    "SearchStats",
    "filtered_search",
]
