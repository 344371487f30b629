"""llama-3.2-vision-90b [vlm] — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision].

Vision encoder (ViT) + projector are a STUB: ``input_specs`` provides
precomputed, already-projected patch embeddings (B, n_image_tokens, d_model).
Every 5th layer is cross-attention (20 of 100 layers).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    n_image_tokens=1601,      # one 560x560 tile -> 1601 patch tokens
    rope_theta=5e5,
    source="hf:meta-llama/Llama-3.2-11B-Vision (90B variant dims)",
)
