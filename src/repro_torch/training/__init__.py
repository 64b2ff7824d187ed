from .optimizer import adamw, adafactor
from .train_step import TrainState, make_train_step

__all__ = ["adamw", "adafactor", "TrainState", "make_train_step"]
