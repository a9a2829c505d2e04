from .train_step import (AdamW, TrainState, ZeroShards, freeze_,
                         frozen_components, full_ema_params, global_norm,
                         init_train_state, make_optimizer, make_train_step)

__all__ = ["AdamW", "TrainState", "ZeroShards", "freeze_",
           "frozen_components", "full_ema_params", "global_norm",
           "init_train_state", "make_optimizer", "make_train_step"]
