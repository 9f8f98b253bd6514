"""hymba-1.5b [hybrid]: parallel attention + mamba heads
[arXiv:2411.13676].  32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001 ssm_state=16; sliding window 1024 everywhere except
full-attention layers every 16 (first/middle)."""

from repro_torch.models import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    block_pattern=("hymba",) * 32,
    sliding_window=1024,
    global_attn_every=16,
    ssm=SSMConfig(d_state=16, expand=2),
)
