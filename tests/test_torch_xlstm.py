"""The port's xLSTM cells (``repro_torch/models/xlstm.py``) against the JAX
package's ``repro/models/xlstm.py`` on the same numpy inputs and JAX's own
init (xlstm-350m.reduced(): d 256, 4 heads), on the CPU, within 1e-4 of
the largest output.

  * mLSTM in chunkwise-parallel form at several chunk lengths (one chunk,
    several, a padded last one), from the initial state (m = -1e30) and as
    a prefill from a carried state, and its one-step recurrent decode; the
    carried C, n, m and conv state too;
  * sLSTM's time loop, from the initial state and carried, and its one-step
    decode;
  * decoding after a prefill gives the full sequence's last outputs;
  * inputs ten times larger (the exponential input gates would overflow
    without the stabiliser) stay finite and agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import xlstm as jxlstm
from repro_torch import interop
from repro_torch.configs.registry import ARCHS
from repro_torch.models import xlstm

REL = 1e-4
ARCH = "xlstm-350m"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny layers: one intra-op thread keeps the suite's parallel workers
    from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (JARCHS[ARCH].reduced().replace(**kw),
            ARCHS[ARCH].reduced().replace(**kw))


@pytest.fixture(scope="module", params=["mlstm", "slstm"])
def cell(request):
    jc, _ = _cfgs()
    init = getattr(jxlstm, f"init_{request.param}")
    jp = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(1), jc))
    return request.param, jp, interop.params_from_numpy(jp)


def _fns(kind):
    return (getattr(jxlstm, f"{kind}_fwd"), getattr(xlstm, f"{kind}_fwd"))


def _states(kind, jp, jc, tc, b):
    if kind == "mlstm":
        return (jxlstm.init_mlstm_state(jp, b, jc),
                xlstm.init_mlstm_state(tc, b))
    return jxlstm.init_slstm_state(jp, b, jc), xlstm.init_slstm_state(tc, b)


def _x(b, s, d, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (b, s, d))).astype(np.float32)


def _close(port, ref, rel=REL):
    ref = np.asarray(ref, np.float32)
    out = port.detach().float().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("chunk,s", [(256, 24), (8, 32), (8, 29), (5, 13)])
@pytest.mark.parametrize("scale", [1.0, 10.0])
def test_full_sequence_matches_jax(cell, chunk, s, scale):
    kind, jp, tp = cell
    jc, tc = _cfgs(scan_chunk=chunk)
    jf, tf = _fns(kind)
    x = _x(2, s, jc.d_model, chunk * s, scale)
    jy, _ = jf(jp, jnp.asarray(x), jc)
    ty, st = tf(tp, torch.from_numpy(x), tc)
    assert st is None
    _close(ty, jy)


def test_initial_states_match_jax(cell):
    kind, jp, _ = cell
    jc, tc = _cfgs()
    js, ts = _states(kind, jp, jc, tc, 3)
    assert sorted(js) == sorted(ts)
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    assert float(ts["m"].max()) == float(np.float32(-1e30))   # not -inf


def test_prefill_then_decode_match_jax(cell):
    """A prefill of 19 steps (chunks of 8), another of 4 from the carried
    state, then 3 one-step decodes: outputs and every carried state."""
    kind, jp, tp = cell
    jc, tc = _cfgs(scan_chunk=8)
    jf, tf = _fns(kind)
    jstate, tstate = _states(kind, jp, jc, tc, 2)
    x = _x(2, 26, jc.d_model, 4)
    for lo, hi in ((0, 19), (19, 23), (23, 24), (24, 25), (25, 26)):
        jy, jstate = jf(jp, jnp.asarray(x[:, lo:hi]), jc, state=jstate)
        ty, same = tf(tp, torch.from_numpy(x[:, lo:hi].copy()), tc,
                      state=tstate)
        assert same is tstate
        _close(ty, jy)
        for k in jstate:
            _close(tstate[k], jstate[k])
    full, _ = tf(tp, torch.from_numpy(x), tc)
    _close(ty, full[:, -1:].numpy())
