"""whisper-large-v3 [audio]: encoder-decoder [arXiv:2212.04356].
32L decoder + 32L encoder, d_model=1280 20H d_ff=5120 vocab=51866.
The mel-spectrogram + conv frontend is a stub, as in the reference: the
encoder takes 1500 precomputed frame features (dim 128), which a learned
projection maps into the model's width."""

from repro_torch.models import ModelConfig
from repro_torch.models.config import EncoderConfig

CONFIG = ModelConfig(
    arch_id="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    mlp_variant="gelu",
    encoder=EncoderConfig(n_layers=32, seq_len=1500),
)
