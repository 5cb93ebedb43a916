"""The LM side: layers, GQA attention, the MoE FFN, the RG-LRU and xLSTM
blocks and the transformer over every layer kind (``repro.models``),
the reference-weight carry-over and the zoo's entry points."""
from repro_torch.models import transformer, zoo
from repro_torch.models.convert import params_from_reference, params_to_reference
from repro_torch.models.transformer import Transformer

__all__ = ["transformer", "zoo", "Transformer", "params_from_reference", "params_to_reference"]
