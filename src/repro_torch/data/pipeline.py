"""Federated data pipeline (port of ``repro/data/pipeline.py``): builds the
client-stacked federation on the device and serves per-round minibatches
(the engine's ``data_fn`` contract)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.data import partition, synthetic


class Federation:
    """Client-stacked dataset on the device; samples per-round batches."""

    def __init__(self, stacked: Dict[str, np.ndarray], batch_size: int,
                 eval_batch: int = 0, *, device):
        self.device = torch.device(device)
        self.data = {k: torch.as_tensor(v).to(self.device)
                     for k, v in stacked.items()}
        self.K = int(stacked["x"].shape[0])
        self.cap = int(stacked["x"].shape[1])
        self.ecap = int(stacked["eval_x"].shape[1])
        self.batch_size = min(batch_size, self.cap)
        self.eval_batch = min(eval_batch or self.ecap, self.ecap)
        self._rows = torch.arange(self.K, device=self.device)[:, None]

    def data_fn(self, round_idx, generator: torch.Generator):
        """Per-client uniform draws with replacement, as ``pipeline.py``'s
        ``_sample``: (K, B) train and (K, eval_batch) eval indices."""
        bi = torch.randint(0, self.cap, (self.K, self.batch_size),
                           generator=generator, device=self.device)
        ei = torch.randint(0, self.ecap, (self.K, self.eval_batch),
                           generator=generator, device=self.device)
        d = self.data
        return {
            "x": d["x"][self._rows, bi],
            "y": d["y"][self._rows, bi],
            "eval_x": d["eval_x"][self._rows, ei],
            "eval_y": d["eval_y"][self._rows, ei],
            "n": d["n"],
        }


def build_federation(seed, *, kind="images", n=4000, n_clients=16,
                     dirichlet_alpha=0.3, batch_size=32, eval_batch=32,
                     n_classes=10, n_features=22, holdout=512, sep=None,
                     device=None):
    """Returns (Federation, server_testset dict) on ``device`` (default:
    the card).  Features are drawn on the CPU from ``seed`` so the
    federation does not depend on the device; the partition uses numpy's
    generator of the same seed, as the JAX package does."""
    dev = device_mod.resolve(device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    if kind == "images":
        x, y = synthetic.make_images(gen, n + holdout, n_classes=n_classes,
                                     sep=sep if sep is not None else 1.5)
    else:
        x, y = synthetic.make_tabular(gen, n + holdout,
                                      n_features=n_features,
                                      n_classes=n_classes,
                                      sep=sep if sep is not None else 2.0)
    x, y = x.numpy(), y.numpy()
    test = {"x": torch.as_tensor(x[n:]).to(dev),
            "y": torch.as_tensor(y[n:]).to(dev)}
    parts = partition.dirichlet_partition(rng, y[:n], n_clients,
                                          dirichlet_alpha)
    stacked = partition.stack_clients(x[:n], y[:n], parts)
    return Federation(stacked, batch_size, eval_batch, device=dev), test
