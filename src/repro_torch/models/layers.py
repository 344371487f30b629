"""Parameter init helpers (port of ``repro/models/layers.py``: the init
the paper models need)."""
from __future__ import annotations

import numpy as np
import torch


def dense_init(generator: torch.Generator, shape, in_axis=0,
               dtype=torch.float32):
    """Truncated-normal fan-in init (LeCun-style): a standard normal cut at
    ±2, scaled by 1/sqrt(fan_in), drawn on the generator's device."""
    fan_in = int(np.prod([shape[i] for i in np.atleast_1d(in_axis)]))
    std = 1.0 / np.sqrt(max(fan_in, 1))
    w = torch.empty(shape, dtype=dtype, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(std)
