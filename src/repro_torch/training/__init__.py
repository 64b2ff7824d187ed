from .optimizer import adamw, adafactor
from .train_step import Shardings, TrainState, make_train_step

__all__ = ["adamw", "adafactor", "Shardings", "TrainState",
           "make_train_step"]
