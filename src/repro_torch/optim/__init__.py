from .optimizers import (Optimizer, adam, adamw, clip_by_global_norm, inverse_sqrt_decay,
                         momentum, sgd)

__all__ = ["Optimizer", "adam", "adamw", "clip_by_global_norm", "inverse_sqrt_decay",
           "momentum", "sgd"]
