from .config import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from .moe import moe_forward
from .params import (
    ParamLayout,
    ParamSpec,
    from_jax_params,
    init_params,
    state_to_tree,
)
from .transformer import forward, loss_fn, model_specs

__all__ = [
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "ParamLayout",
    "ParamSpec",
    "SSMConfig",
    "from_jax_params",
    "init_params",
    "state_to_tree",
    "forward",
    "loss_fn",
    "model_specs",
    "moe_forward",
]
