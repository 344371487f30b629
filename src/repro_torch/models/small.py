"""The paper's own model scale: small CNN (MNIST / X-ray) and MLP (Crop).

Port of ``repro/models/small.py``.  The public layout is the JAX one:
NHWC images, HWIO conv weights, (in, out) dense weights, so parameters
convert by plain copies; the permutes to PyTorch's NCHW/OIHW happen only
around the ``F.conv2d`` call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def init_cnn(generator, cfg, in_channels=1, image_size=28):
    """n_layers 3x3 stride-2 conv blocks + dense layer + head."""
    c = cfg.d_model
    dev = generator.device
    params = {"convs": []}
    cin, size = in_channels, image_size
    for i in range(cfg.n_layers):
        cout = c * (2 ** i)
        params["convs"].append({
            "w": dense_init(generator, (3, 3, cin, cout), in_axis=(0, 1, 2)),
            "b": torch.zeros((cout,), device=dev),
        })
        cin = cout
        size = (size + 1) // 2
    feat = size * size * cin
    params["dense"] = {"w": dense_init(generator, (feat, cfg.d_ff)),
                       "b": torch.zeros((cfg.d_ff,), device=dev)}
    params["head"] = {"w": dense_init(generator, (cfg.d_ff, cfg.vocab_size)),
                      "b": torch.zeros((cfg.vocab_size,), device=dev)}
    return params


def _same_pad(size, k=3, s=2):
    """XLA's ``padding="SAME"``: (before, after) with the odd pixel after —
    (0, 1) for 28->14 and 14->7, which ``F.conv2d`` cannot express."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def cnn_fwd(params, x):
    """x: (B, H, W, C) -> logits (B, n_classes)."""
    x = x.permute(0, 3, 1, 2)                             # NCHW for conv2d
    for cp in params["convs"]:
        (ht, hb), (wl, wr) = _same_pad(x.shape[2]), _same_pad(x.shape[3])
        x = F.pad(x, (wl, wr, ht, hb))
        x = F.conv2d(x, cp["w"].permute(3, 2, 0, 1), stride=2)
        x = torch.relu(x + cp["b"][:, None, None])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)     # NHWC flatten
    x = torch.relu(x @ params["dense"]["w"] + params["dense"]["b"])
    return x @ params["head"]["w"] + params["head"]["b"]


def init_mlp_clf(generator, cfg):
    dims = [cfg.d_model] + [cfg.d_ff] * (cfg.n_layers - 1) + [cfg.vocab_size]
    return {"layers": [
        {"w": dense_init(generator, (dims[i], dims[i + 1])),
         "b": torch.zeros((dims[i + 1],), device=generator.device)}
        for i in range(cfg.n_layers)
    ]}


def mlp_clf_fwd(params, x):
    """x: (B, F) -> logits (B, n_classes)."""
    n = len(params["layers"])
    for i, lp in enumerate(params["layers"]):
        x = x @ lp["w"] + lp["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def classifier_loss(logits, labels):
    """(mean CE, accuracy) — fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None].long())[:, 0]
    loss = (logz - gold).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc
