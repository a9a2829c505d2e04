from .train_step import (TrainState, global_norm, init_train_state,
                         make_optimizer, make_train_step)

__all__ = ["TrainState", "global_norm", "init_train_state", "make_optimizer",
           "make_train_step"]
