from .optimizers import Optimizer, momentum, sgd

__all__ = ["Optimizer", "momentum", "sgd"]
