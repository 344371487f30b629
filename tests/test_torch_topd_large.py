"""K7's route past the shared-memory budget: cohorts of d > 16,384 out of
M = 10^5 Gumbel keys.

There ``topd_pallas`` raises blk to d, so each block's candidates are all
its keys.  On the CPU the port runs its plain version
(``topd_pallas_plain``: d rounds of max-and-mask a block, then the stable
merge); it must return the JAX package's ``topd_pallas`` indices (K7 in
interpret mode, then ``lax.top_k``) exactly, at d = 16,385 and 20,000 and
on keys tied at +-0.0 whose top-d reaches the blocks' -inf tails.  The
card path (``ps_topd_global``) is held bitwise against this plain version
in ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 2b.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import population_select as jps
from repro_torch.kernels import population_select as ps
from repro_torch.kernels import topd_checks


@pytest.mark.parametrize("m,d,kind", [(100_000, 16_385, "gumbel"),
                                      (100_000, 20_000, "gumbel"),
                                      (40_000, 16_500, "neginf")])
def test_plain_route_past_shared_memory_matches_jax(m, d, kind):
    g = topd_checks.keys(m, d, d, kind, seed=d, device="cpu").numpy()
    want = np.asarray(jps.topd_pallas(jnp.asarray(g), d))
    got = ps.topd_pallas(torch.from_numpy(g), d)
    assert got.dtype == torch.int32 and got.shape == (d,)
    np.testing.assert_array_equal(got.numpy(), want)
    # the dispatcher's pallas route is this one
    np.testing.assert_array_equal(
        ps.topd(torch.from_numpy(g), d, method="pallas").numpy(), want)
