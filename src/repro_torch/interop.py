"""Conversion of state between the JAX package and the port.

Both packages keep the same layout (NHWC/HWIO/(in, out)) and the same
nested dict/list structure, so params are a plain copy leaf by leaf, in
JAX's flatten order (dict keys sorted).  Per-client state that the port
keeps as one (K, N) buffer in the round's column order (EF residuals) and
wire records (``comm/codecs.py``) are the JAX per-leaf arrays concatenated
along the column axis; so are the parked rows of the async engine's
``DeliveryBuffer``.  The port never imports jax: the caller turns JAX
arrays into numpy first, e.g. ``jax.tree_util.tree_map(np.asarray, t)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.comm import codecs
from repro_torch.core import async_engine, clientstore
from repro_torch.serve import scheduler

_RECORDS = {("q", "s"): codecs.QuantLeaf, ("bits", "s"): codecs.SignLeaf,
            ("idx", "val"): codecs.SparseLeaf}


def params_from_numpy(np_tree, device="cpu"):
    """numpy tree -> tensor tree (copies) on ``device``."""
    return tree.map(lambda a: torch.tensor(np.asarray(a), device=device),
                    np_tree)


def params_to_numpy(params):
    """tensor tree -> numpy tree (copies, on the host)."""
    return tree.map(lambda t: t.detach().cpu().numpy().copy(), params)


def rows_from_numpy(np_tree, device="cpu"):
    """A tree of (K, ...) arrays (e.g. JAX's EF residuals) -> the port's
    (K, N) fp32 buffer, leaves side by side in JAX's order."""
    ls = [np.asarray(l) for l in tree.leaves(np_tree)]
    k = ls[0].shape[0]
    return torch.tensor(np.concatenate([l.reshape(k, -1) for l in ls], 1),
                        dtype=torch.float32, device=device)


def wire_from_numpy(enc_tree, device="cpu"):
    """A JAX encoded tree (per-leaf QuantLeaf / SignLeaf / SparseLeaf
    records holding numpy arrays) -> the port's one record over the whole
    ``codecs.WireLayout``: each field's per-leaf arrays concatenated along
    the column axis.  Records are told apart by their field names."""
    recs = tree.leaves(enc_tree, is_leaf=lambda x: hasattr(x, "_fields"))
    fields = tuple(recs[0]._fields)
    return _RECORDS[fields](*(
        torch.tensor(np.concatenate([np.asarray(getattr(r, f)) for r in recs],
                                    axis=1), device=device)
        for f in fields))


def attacker_from_numpy(carry, device="cpu"):
    """A stateful attacker's carry ``(blend, prev_gated)`` (numpy, e.g.
    JAX's ``FedState.attacker``) -> the port's: a 0-d fp32 blend and the
    (K,) or (M,) gate column."""
    blend, prev_gated = carry
    return (torch.tensor(np.asarray(blend, np.float32), device=device),
            torch.tensor(np.asarray(prev_gated, np.float32), device=device))


def store_from_numpy(jstore, device="cpu"):
    """A JAX ``ClientStore`` (numpy columns) -> the port's: the same
    columns and dtypes, EF residuals as one (M, N) buffer."""
    col = lambda a: torch.tensor(np.asarray(a), device=device)
    return clientstore.ClientStore(
        fitness=col(jstore.fitness), trust=col(jstore.trust),
        gate_trust=col(jstore.gate_trust), staleness=col(jstore.staleness),
        failures=col(jstore.failures), cum_selected=col(jstore.cum_selected),
        ef=None if jstore.ef is None else rows_from_numpy(jstore.ef, device))


def buffer_from_numpy(jbuf, params, fed_cfg):
    """A JAX ``DeliveryBuffer`` (numpy leaves) -> the port's, on the device
    of ``params``: the parked rows in JAX's flatten order inside a fresh
    (C + B + 1, N) row matrix, and the (B,) columns."""
    dev = tree.leaves(params)[0].device
    buf = async_engine.init_buffer(params, fed_cfg,
                                   upd=rows_from_numpy(jbuf.upd, dev))
    col = lambda a: torch.tensor(np.asarray(a), device=dev)
    return buf._replace(owner=col(jbuf.owner), n_k=col(jbuf.n_k),
                        age=col(jbuf.age), remaining=col(jbuf.remaining),
                        active=col(jbuf.active))


def pools_from_numpy(np_pools, device="cpu", page_axis=1):
    """JAX paged KV pools (a tree whose ``kp``/``vp``/``ks``/``vs`` leaves
    have their page axis at ``page_axis``: 1 for the engine's stacked
    pools, 0 for one layer's cache) -> the port's, with the zero drop page
    appended after the last page.  Other leaves (the scheduler context)
    are copied as they are."""
    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        a = np.asarray(t)
        if key in ("kp", "vp", "ks", "vs"):
            shape = list(a.shape)
            shape[page_axis] = 1
            a = np.concatenate([a, np.zeros(shape, a.dtype)], page_axis)
        return torch.tensor(a, device=device)

    return walk(np_pools)


def slot_state_from_numpy(jst, generator, device="cpu"):
    """A JAX ``SlotState`` (numpy fields) -> the port's: the same columns
    (token ids and request ids as int64), the same telemetry column, and
    ``generator`` in place of the PRNG key."""
    col = lambda a, dtype=None: torch.tensor(np.asarray(a), dtype=dtype,
                                             device=device)
    return scheduler.SlotState(
        tok=col(jst.tok, torch.int64), length=col(jst.length),
        budget=col(jst.budget), active=col(jst.active),
        req_id=col(jst.req_id, torch.int64), alloc=col(jst.alloc),
        table=col(jst.table), free=col(jst.free),
        tele={k: col(v) for k, v in jst.tele.items()}, gen=generator)
