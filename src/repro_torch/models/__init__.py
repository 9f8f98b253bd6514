from .config import EncoderConfig, MLAConfig, ModelConfig, MoEConfig, SSMConfig
from .hybrid import hymba_decode, hymba_forward, init_hymba_cache
from .moe import moe_forward
from .params import (
    ParamLayout,
    ParamSpec,
    count_params,
    from_jax_params,
    init_params,
    state_to_tree,
)
from .ssm import mamba_decode, mamba_forward, mamba_scan_chunked, mamba_scan_loop
from .transformer import forward, loss_fn, model_specs

__all__ = [
    "EncoderConfig",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "ParamLayout",
    "ParamSpec",
    "SSMConfig",
    "count_params",
    "from_jax_params",
    "init_params",
    "state_to_tree",
    "forward",
    "hymba_decode",
    "hymba_forward",
    "init_hymba_cache",
    "loss_fn",
    "mamba_decode",
    "mamba_forward",
    "mamba_scan_chunked",
    "mamba_scan_loop",
    "model_specs",
    "moe_forward",
]
