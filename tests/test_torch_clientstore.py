"""The port's population-scale client store (repro_torch/core/clientstore.py)
against the JAX package's, on the same numpy columns.

The owner lists hold duplicates (a client's fresh and buffered rows in one
round) and rows that the JAX package scatters out of range and drops.  The
results must be exact: the scatters move or multiply single fp32 values,
and duplicates resolve as on XLA's CPU backend (adds and products
compound, the last set wins).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clientstore as jcs
from repro_torch import interop
from repro_torch.core import clientstore as cs

M = 40


def _stores(seed=0):
    """A JAX store with varied columns, and the port's copy of it."""
    rng = np.random.default_rng(seed)
    j = jcs.init_store(M)._replace(
        fitness=jnp.asarray(rng.uniform(0, 1, M).astype(np.float32)),
        trust=jnp.asarray(rng.uniform(0.1, 1, M).astype(np.float32)),
        gate_trust=jnp.asarray(rng.uniform(0.2, 1, M).astype(np.float32)),
        staleness=jnp.asarray(rng.integers(0, 5, M).astype(np.int32)),
        failures=jnp.asarray(rng.integers(0, 3, M).astype(np.float32)),
        cum_selected=jnp.asarray(rng.integers(0, 9, M).astype(np.float32)))
    return j, interop.store_from_numpy(_np(j))


def _np(store):
    return type(store)(*(None if c is None else np.asarray(c) for c in store))


def _same(port, jax_store):
    for name, a, b in zip(port._fields, port, jax_store):
        if a is None:
            assert b is None
            continue
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


# owners as the async round builds them: 8 fresh cohort rows, then 6
# buffer rows; clients 3 and 11 appear twice, buffer rows 12 and 13 are
# inactive slots whose owner is 0
OWNERS = np.array([5, 3, 17, 11, 30, 2, 39, 8, 3, 11, 21, 3, 0, 0], np.int32)
MASKS = [np.array(m, np.float32) for m in (
    [1, 1, 0, 1, 1, 0, 1, 1, 1, 1, 0, 1, 0, 0],
    [0, 1, 1, 0, 0, 1, 0, 0, 1, 0, 1, 1, 0, 0],
    [1] * 14,
    [0] * 14,
)]


def test_init_store_matches():
    _same(cs.init_store(M), jcs.init_store(M))
    assert cs.init_store(M).population == M


def test_gather_and_selection_priority():
    j, p = _stores()
    idx = np.array([4, 0, 39, 17, 4], np.int32)
    _same(cs.gather(p, torch.from_numpy(idx)), jcs.gather(j, jnp.asarray(idx)))
    np.testing.assert_array_equal(cs.selection_priority(p).numpy(),
                                  np.asarray(jcs.selection_priority(j)))
    zero = p._replace(trust=torch.zeros(M))         # floored at 1e-12
    assert float(cs.selection_priority(zero).min()) == np.float32(1e-12)


def test_record_selection_and_fitness():
    j, p = _stores(1)
    idx = np.array([9, 1, 33, 20], np.int32)
    scores = np.random.default_rng(2).uniform(0, 1, 4).astype(np.float32)
    _same(cs.record_selection(p, torch.from_numpy(idx)),
          jcs.record_selection(j, jnp.asarray(idx)))
    _same(cs.record_fitness(p, torch.from_numpy(idx),
                            torch.from_numpy(scores), 0.9),
          jcs.record_fitness(j, jnp.asarray(idx), jnp.asarray(scores), 0.9))


@pytest.mark.parametrize("k", range(len(MASKS)))
def test_record_deliveries(k):
    j, p = _stores(3)
    _same(cs.record_deliveries(p, torch.from_numpy(OWNERS),
                               torch.from_numpy(MASKS[k])),
          jcs.record_deliveries(j, jnp.asarray(OWNERS), jnp.asarray(MASKS[k])))


@pytest.mark.parametrize("k", range(len(MASKS)))
def test_record_failures_compounds_duplicates(k):
    j, p = _stores(4)
    _same(cs.record_failures(p, torch.from_numpy(OWNERS),
                             torch.from_numpy(MASKS[k])),
          jcs.record_failures(j, jnp.asarray(OWNERS), jnp.asarray(MASKS[k])))
    if k == 2:                             # client 3: three failed rows
        out = cs.record_failures(p, torch.from_numpy(OWNERS),
                                 torch.from_numpy(MASKS[k]))
        assert float(out.failures[3]) == float(p.failures[3]) + 3.0


@pytest.mark.parametrize("k", range(len(MASKS)))
def test_record_gate_trust_last_row_wins(k):
    j, p = _stores(5)
    gated = np.random.default_rng(k).integers(0, 2, 14).astype(np.float32)
    _same(cs.record_gate_trust(p, torch.from_numpy(OWNERS),
                               torch.from_numpy(MASKS[k]),
                               torch.from_numpy(gated), 0.9),
          jcs.record_gate_trust(j, jnp.asarray(OWNERS), jnp.asarray(MASKS[k]),
                                jnp.asarray(gated), 0.9))


def test_record_gate_trust_takes_the_last_participating_row():
    """Client 3 has rows 1, 8 and 11; with row 11 out, row 8's value
    stands, whatever rows 1 and 11 hold."""
    _, p = _stores(6)
    part = np.ones(14, np.float32)
    part[11] = 0.0
    gated = np.zeros(14, np.float32)
    gated[8] = 1.0                            # row 8: gated -> decays
    out = cs.record_gate_trust(p, torch.from_numpy(OWNERS),
                               torch.from_numpy(part),
                               torch.from_numpy(gated), 0.9)
    assert float(out.gate_trust[3]) == float(
        np.float32(0.9) * p.gate_trust[3].numpy())
