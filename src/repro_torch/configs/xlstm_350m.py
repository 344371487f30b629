"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

d_ff=0: xLSTM blocks carry their own up/down projections.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    arch_type="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm_state=16,
    source="arXiv:2405.04517 (xLSTM), 350M config",
)
