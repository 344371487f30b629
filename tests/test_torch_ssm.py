"""The port's Mamba block (``repro_torch/models/ssm.py``) and the layers it
shares with the xLSTM cells (``layers.causal_depthwise_conv``,
``layers.group_norm``) against the JAX package on the same numpy inputs
and JAX's own init (hymba-1.5b.reduced(): d 256, d_inner 512, state 16),
on the CPU.

Tolerances (of the largest output): fp32 1e-5, the bf16 scan dtype 2^-6.
``lax.associative_scan`` combines in a tree; the port runs the same
recursion, but XLA fuses and orders the products and the readout's sums
its own way, and in bf16 it may keep an intermediate in fp32 where the
port rounds it.  The chunked scan is run at several chunk lengths, with a
padded last chunk, from a zero state and from a carried one (prefill),
and one recurrent step at a time (decode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch import interop
from repro_torch.configs.registry import ARCHS
from repro_torch.models import layers, ssm

REL = 1e-5
BF16_REL = 2.0 ** -6
ARCH = "hymba-1.5b"


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


@pytest.fixture(scope="module")
def params():
    jc, _ = _cfgs()
    jp = jax.tree_util.tree_map(
        np.asarray, jssm.init_mamba(jax.random.PRNGKey(0), jc))
    return jp, interop.params_from_numpy(jp)


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _close(port, ref, rel=REL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(port.detach().float().numpy(), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _jstate(state):
    return {k: jnp.asarray(v.numpy()) for k, v in state.items()}


def test_conv_and_group_norm_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    kern = rng.standard_normal((4, 24)).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    jy, _ = jlayers.causal_depthwise_conv(jnp.asarray(x), kern, bias)
    ty, st = layers.causal_depthwise_conv(*map(torch.from_numpy,
                                               (x, kern, bias)))
    assert st is None
    _close(ty, jy)
    state = rng.standard_normal((2, 3, 24)).astype(np.float32)
    jy, jst = jlayers.causal_depthwise_conv(jnp.asarray(x[:, :1]), kern,
                                            bias, jnp.asarray(state))
    ty, tst = layers.causal_depthwise_conv(
        *map(torch.from_numpy, (x[:, :1].copy(), kern, bias, state)))
    _close(ty, jy)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    scale = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    for groups in (1, 4, 24):
        _close(layers.group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                                 groups),
               jlayers.group_norm(jnp.asarray(x), scale, groups))


def test_softplus_is_logaddexp_past_torch_threshold():
    x = np.array([-50.0, -3.0, 0.0, 3.0, 19.9, 20.1, 30.0, 80.0], np.float32)
    np.testing.assert_array_equal(ssm._softplus(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.nn.softplus(x)))


@pytest.mark.parametrize("n", [1, 2, 5, 16, 17, 64])
def test_associative_scan_matches_lax(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 3, 4)).astype(np.float32)

    def combine(l, r):
        return l[0] * r[0], r[0] * l[1] + r[1]

    ja, jb = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    ta, tb = ssm.associative_scan([torch.from_numpy(a), torch.from_numpy(b)])
    _close(ta, ja, 1e-6)
    _close(tb, jb, 1e-6)
    h = np.zeros_like(b[:, 0])
    for t in range(n):                  # the sequential recurrence
        h = a[:, t] * h + b[:, t]
    _close(tb[:, -1], h, 1e-6)


@pytest.mark.parametrize("chunk,s", [(256, 40), (16, 40), (8, 64), (7, 30)])
@pytest.mark.parametrize("dtype,rel", [("float32", REL),
                                       ("bfloat16", BF16_REL)])
def test_full_sequence_matches_jax(params, chunk, s, dtype, rel):
    jc, tc = _cfgs(scan_chunk=chunk, ssm_scan_dtype=dtype)
    jp, tp = params
    x = _x(2, s, jc.d_model, chunk + s)
    jy, _ = jssm.mamba_fwd(jp, jnp.asarray(x), jc)
    ty, st = ssm.mamba_fwd(tp, torch.from_numpy(x), tc)
    assert st is None
    _close(ty, jy, rel)


@pytest.mark.parametrize("dtype,rel", [("float32", REL),
                                       ("bfloat16", BF16_REL)])
def test_prefill_then_decode_match_jax(params, dtype, rel):
    """A prefill of 21 steps (chunks of 8, the last padded) from the zero
    state, a second prefill of 5 from the carried state, then 4 one-step
    decodes: every output and the carried h and conv state."""
    jc, tc = _cfgs(scan_chunk=8, ssm_scan_dtype=dtype)
    jp, tp = params
    jstate = jssm.init_mamba_state(jp, 2, jc)
    tstate = ssm.init_mamba_state(tc, 2)
    assert {k: v.shape for k, v in jstate.items()} == \
        {k: tuple(v.shape) for k, v in tstate.items()}
    x = _x(2, 30, jc.d_model, 3)
    for lo, hi in ((0, 21), (21, 26), (26, 27), (27, 28), (28, 29),
                   (29, 30)):
        jy, jstate = jssm.mamba_fwd(jp, jnp.asarray(x[:, lo:hi]), jc,
                                    state=jstate)
        ty, same = ssm.mamba_fwd(tp, torch.from_numpy(x[:, lo:hi].copy()),
                                 tc, state=tstate)
        assert same is tstate
        _close(ty, jy, rel)
        _close(tstate["h"], jstate["h"], rel)
        _close(tstate["conv"], jstate["conv"], REL)
    # decode after prefill equals the full sequence's last outputs
    full, _ = ssm.mamba_fwd(tp, torch.from_numpy(x), tc)
    _close(ty, full[:, -1:].numpy(), rel)
