"""The port's fault injection (repro_torch/core/faults.py) against the JAX
package's: the delay scales of the chronic stragglers (head and tail rows)
and each sampler's pure function fed the uniforms that JAX's sampler draws
from the same key.  Masks and epoch counts are exact; delays agree to one
ulp of the log (rtol 1e-6), since the two packages' ``log`` may round
differently."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro_torch.core import faults

CONFIGS = [
    faults.FaultConfig(),
    faults.FaultConfig(straggler_frac=0.3, straggler_delay=3.0,
                       base_delay=0.3),
    faults.FaultConfig(straggler_frac=0.05, straggler_delay=50.0),
    faults.FaultConfig(dropout_prob=0.25, partial_min_frac=0.4),
    faults.FaultConfig(base_delay=0.7, deadline=0.5),
]


def _jax(fl):
    return jfaults.FaultConfig(**fl.__dict__)


@pytest.mark.parametrize("k", range(len(CONFIGS)))
def test_flags_and_delay_scales(k):
    fl = CONFIGS[k]
    jfl = _jax(fl)
    for flag in ("stragglers_active", "dropout_active", "partial_active",
                 "active"):
        assert getattr(fl, flag) == getattr(jfl, flag), flag
    for rows in ("head", "tail"):
        for n in (1, 7, 24, 100):
            np.testing.assert_array_equal(
                faults.delay_scales(fl, n, rows=rows).numpy(),
                np.asarray(jfaults.delay_scales(jfl, n, rows=rows)))
    with pytest.raises(ValueError):
        faults.delay_scales(fl, 4, rows="middle")


@pytest.mark.parametrize("rows", ["head", "tail"])
def test_sample_delays_fed_jax_uniforms(rows):
    fl = CONFIGS[1]
    scale = jfaults.delay_scales(_jax(fl), 64, rows=rows)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jfaults.sample_delays(scale, key))
    u = np.array(jax.random.uniform(key, (64,), minval=1e-7, maxval=1.0))
    out = faults.sample_delays(faults.delay_scales(fl, 64, rows=rows),
                               torch.from_numpy(u))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
    np.testing.assert_array_equal((out <= 1.0).numpy(), ref <= 1.0)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_sample_arrivals_fed_jax_uniforms(k):
    fl = CONFIGS[k]
    key = jax.random.PRNGKey(k)
    ref = np.asarray(jfaults.sample_arrivals(_jax(fl), key, 50))
    u = np.array(jax.random.uniform(key, (50,), minval=1e-7, maxval=1.0))
    out = faults.sample_arrivals(fl, torch.from_numpy(u))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_sample_dropout_fed_jax_uniforms():
    fl = CONFIGS[3]
    team = (np.arange(40) % 3 != 0).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jfaults.sample_dropout(_jax(fl), key, jnp.asarray(team)))
    u = np.array(jax.random.uniform(key, (40,)))
    out = faults.sample_dropout(fl, torch.from_numpy(u),
                                torch.from_numpy(team))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert 0 < out.sum() < team.sum()


@pytest.mark.parametrize("epochs", [1, 3, 5])
def test_sample_epochs_fed_jax_uniforms(epochs):
    fl = CONFIGS[3]
    key = jax.random.PRNGKey(epochs)
    ref = np.asarray(jfaults.sample_epochs(_jax(fl), key, 40, epochs))
    frac = np.array(jax.random.uniform(
        key, (40,), minval=fl.partial_min_frac, maxval=1.0))
    out = faults.sample_epochs(torch.from_numpy(frac), epochs)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_draws_lie_in_their_ranges():
    gen = torch.Generator().manual_seed(0)
    fl = CONFIGS[3]
    u = faults.draw_delays(10_000, gen)
    assert float(u.min()) >= 1e-7 and float(u.max()) < 1.0
    assert bool(torch.isfinite(faults.sample_delays(torch.ones(10_000),
                                                    u)).all())
    frac = faults.draw_epochs(fl, 10_000, gen)
    assert float(frac.min()) >= fl.partial_min_frac
    assert float(frac.max()) < 1.0
    eff = faults.sample_epochs(frac, 3)
    assert set(eff.tolist()) <= {1, 2, 3}
    d = faults.sample_dropout(fl, faults.draw_dropout(10_000, gen),
                              torch.ones(10_000))
    assert abs(float(d.mean()) - fl.dropout_prob) < 0.02
    arr = faults.sample_arrivals(CONFIGS[1], faults.draw_arrivals(1000, gen))
    assert 0 < float(arr.sum()) < 1000
