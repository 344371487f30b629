"""minitron-4b [dense] — pruned nemotron [arXiv:2407.14679]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    source="arXiv:2407.14679 (Minitron / Compact LMs via pruning+distill)",
)
