"""Training on one device (``repro.train``)."""
from repro_torch.train.train_step import (
    TrainHParams,
    TrainState,
    make_train_state,
    make_train_step,
)

__all__ = ["TrainHParams", "TrainState", "make_train_state", "make_train_step"]
