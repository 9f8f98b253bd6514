from .config import ModelConfig, SSMConfig
from .params import (
    ParamLayout,
    ParamSpec,
    from_jax_params,
    init_params,
)
from .transformer import forward, loss_fn, model_specs

__all__ = [
    "ModelConfig",
    "ParamLayout",
    "ParamSpec",
    "SSMConfig",
    "from_jax_params",
    "init_params",
    "forward",
    "loss_fn",
    "model_specs",
]
