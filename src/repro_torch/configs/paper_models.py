"""The paper's own model scale: small CNN (X-ray/MNIST), MLP (Crop) and
the ~100M decoder of the FL-LM example (copies of
``repro/configs/paper_models.py``)."""
from repro_torch.configs.base import ModelConfig

# MNIST / X-ray style: 28x28 grayscale, 10 classes
CNN_CONFIG = ModelConfig(
    name="paper-cnn",
    arch_type="cnn",
    n_layers=2,               # conv blocks
    d_model=32,               # base channels
    n_heads=1,
    n_kv_heads=1,
    d_ff=128,                 # dense head width
    vocab_size=10,            # n_classes
    remat=False,
    dtype="float32",
    source="paper SSVI-A (Pneumonia X-ray / MNIST CNN)",
)

# Crop Recommendation: 22 features, 22 classes (paper SSVI-D)
MLP_CONFIG = ModelConfig(
    name="paper-mlp",
    arch_type="mlp",
    n_layers=3,
    d_model=22,               # n_features
    n_heads=1,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=22,            # n_classes
    remat=False,
    dtype="float32",
    source="paper SSVI-D (Crop Recommendation tabular)",
)

# ~100M decoder for the end-to-end FL-LM training example
TINY_LM = ModelConfig(
    name="tiny-lm",
    arch_type="dense",
    n_layers=8,
    d_model=512,
    n_heads=8,
    n_kv_heads=4,
    d_ff=2048,
    vocab_size=32000,
    remat=False,
    dtype="float32",
    source="in-repo ~100M example config",
)
