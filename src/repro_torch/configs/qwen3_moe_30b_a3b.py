"""qwen3-moe-30b-a3b [moe]: 128 experts, top-8 routing
[hf:Qwen/Qwen3-30B-A3B].  48L d_model=2048 32H (GQA kv=4, head_dim=128)
expert d_ff=768 vocab=151936.  ~3B active / ~30B total parameters."""

from repro_torch.models import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    moe=MoEConfig(
        n_experts=128,
        top_k=8,
        d_expert=768,
        n_shared=0,
        capacity_factor=1.25,
    ),
)
