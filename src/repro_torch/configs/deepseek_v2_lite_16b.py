"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512) + fine-grained MoE
[arXiv:2405.04434].  27L d_model=2048 16H d_ff=1408(expert)
vocab=102400; 2 shared + 64 routed experts, top-6; first layer dense
(d_ff=10944) as in the reference model.  The MLA decode path caches
only (c_kv, k_rope) — 576 dims/token instead of 2*16*128."""

from repro_torch.models import MLAConfig, ModelConfig, MoEConfig

_PATTERN = ("mla",) + ("mla_moe",) * 26

CONFIG = ModelConfig(
    arch_id="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,  # dense first layer; experts use moe.d_expert
    vocab_size=102400,
    block_pattern=_PATTERN,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_expert=1408,
        n_shared=2,
        d_shared=1408,
        capacity_factor=1.25,
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        q_lora_rank=0,
    ),
)
