"""internvl2-76b [vlm]: InternViT + LLM backbone [arXiv:2404.16821].
Backbone: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The vision encoder is a stub, as in the reference: 256 precomputed patch
embeddings (dim 1024) that a learned projector maps into the LM
embedding space."""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    vision_prefix_len=256,
)
