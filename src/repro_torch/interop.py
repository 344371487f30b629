"""Conversion of parameter trees between the JAX package and the port.

Both packages keep the same layout (NHWC/HWIO/(in, out)) and the same
nested dict/list structure, so each direction is a plain copy leaf by
leaf, in JAX's flatten order (dict keys sorted).  The port never imports
jax: the caller turns JAX arrays into numpy first, e.g.
``jax.tree_util.tree_map(np.asarray, params)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree


def params_from_numpy(np_tree, device="cpu"):
    """numpy tree -> tensor tree (copies) on ``device``."""
    return tree.map(lambda a: torch.tensor(np.asarray(a), device=device),
                    np_tree)


def params_to_numpy(params):
    """tensor tree -> numpy tree (copies, on the host)."""
    return tree.map(lambda t: t.detach().cpu().numpy().copy(), params)
