"""musicgen-large [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec frontend (mel-spectrogram + conv codec) is a STUB:
``input_specs`` provides precomputed frame embeddings (B, S, d_model);
the decoder predicts codebook tokens over vocab=2048.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    n_codebooks=4,
    embed_inputs=False,
    source="arXiv:2306.05284 (MusicGen)",
)
