"""granite-20b [dense]: code model, GPT-BigCode-style MQA
[arXiv:2405.04324].  52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152; GELU MLP."""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    mlp_variant="gelu",
)
