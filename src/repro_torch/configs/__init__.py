"""Model configurations: copies of ``repro.configs`` — the schema and the
ten arch modules, each exporting ``CONFIG`` and ``smoke_config()``."""
from repro_torch.configs.base import ModelConfig, ShapeConfig, ALL_SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, shapes_for
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
