"""xlstm-350m [ssm]: sLSTM + mLSTM block stack [arXiv:2405.04517].
24L d_model=1024 4H d_ff=0 (mLSTM blocks carry an internal 2x
up-projection instead of a separate FFN) vocab=50304.
Pattern: sLSTM at every 6th position (xLSTM[~7:1] ratio)."""

from repro_torch.models import ModelConfig, SSMConfig

_PATTERN = tuple(
    "slstm" if (i % 6 == 3) else "mlstm" for i in range(24)
)

CONFIG = ModelConfig(
    arch_id="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=_PATTERN,
    ssm=SSMConfig(d_state=16, expand=2),
)
