"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,               # per-expert FFN width
    vocab_size=100352,
    n_experts=16,
    top_k=4,
    rope_theta=5e5,
    source="hf:databricks/dbrx-base",
)
