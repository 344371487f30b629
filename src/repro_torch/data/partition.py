"""Non-IID client partitioning (Dirichlet label skew) — numpy only, a copy
of ``repro/data/partition.py``: the same numpy seed gives the same
partition in both packages.

Outputs client-stacked fixed-capacity arrays (K, cap, ...) + true sizes
(K,) so the whole federation is one stack of tensors.
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(rng: np.random.Generator, labels: np.ndarray,
                        n_clients: int, alpha: float):
    """Returns a list of index arrays, one per client (label-skewed)."""
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    client_idx = [[] for _ in range(n_clients)]
    for c, idx in enumerate(idx_by_class):
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx, cuts)):
            client_idx[k].extend(part.tolist())
    out = []
    for k in range(n_clients):
        a = np.asarray(client_idx[k], dtype=np.int64)
        rng.shuffle(a)
        if len(a) == 0:                     # guarantee non-empty clients
            a = np.array([rng.integers(0, len(labels))], dtype=np.int64)
        out.append(a)
    return out


def stack_clients(x: np.ndarray, y: np.ndarray, parts, *, eval_frac=0.2,
                  cap=None):
    """Fixed-capacity stacked federation arrays.

    Returns dict(x (K,cap,...), y (K,cap), eval_x (K,ecap,...), eval_y,
    n (K,)) — short clients are padded by cycling their own data (n holds
    the true size so q_k stays correct).
    """
    sizes = np.array([len(p) for p in parts])
    cap = cap or int(sizes.max())
    e_sizes = np.maximum((sizes * eval_frac).astype(int), 1)
    t_sizes = np.maximum(sizes - e_sizes, 1)
    ecap = max(int(e_sizes.max()), 1)

    def take(idx, count, capacity):
        sub = idx[:count]
        if len(sub) == 0:           # degenerate (single-sample) client
            sub = idx if len(idx) else np.array([0], dtype=np.int64)
        reps = int(np.ceil(capacity / len(sub)))
        return np.tile(sub, reps)[:capacity]

    xs, ys, exs, eys = [], [], [], []
    for k, p in enumerate(parts):
        tr = take(p, t_sizes[k], cap)
        ev = take(p[t_sizes[k]:], e_sizes[k], ecap)
        xs.append(x[tr]); ys.append(y[tr])
        exs.append(x[ev]); eys.append(y[ev])
    return {
        "x": np.stack(xs), "y": np.stack(ys),
        "eval_x": np.stack(exs), "eval_y": np.stack(eys),
        "n": t_sizes.astype(np.float32),
    }


def size_skew_partition(rng: np.random.Generator, n_total: int,
                        n_clients: int, zipf_a: float = 1.3):
    """Zipf-distributed client sizes (for data-quality q_k experiments)."""
    raw = 1.0 / np.arange(1, n_clients + 1) ** zipf_a
    sizes = np.maximum((raw / raw.sum() * n_total).astype(int), 2)
    idx = rng.permutation(n_total)
    cuts = np.cumsum(sizes)[:-1]
    return [p for p in np.split(idx, cuts)][:n_clients]
