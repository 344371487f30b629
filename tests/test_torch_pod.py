"""The port's PodEngine (``repro_torch/core/pod.py``) against the JAX
package's ``make_train_step`` on the same numpy init and batches, at the
JAX tests' small config (tiny-lm with 2 layers, d 64, 4/2 heads, d_ff 128,
vocab 128; C 4, B 8, S 32, ``tests/test_pod_engine.py``), on the CPU,
where the port's kernel wrappers run their plain versions and JAX's
Pallas kernels run in interpret mode.

  * two steps of ``robust=None`` (one weighted backward) and of
    ``robust='per_client'`` under fedavg and trimmed_mean (here) and
    median, krum and int8 with error feedback (the fused-dequant path,
    ``tests/test_torch_pod_robust.py``, a file of its own so that the
    suite's workers share the JAX compiles), with
    ``optimizer="sgd"`` (Adam's first step is +-lr sign(g), which flips
    where a grad is at rounding level): team, h, the slot counter, round
    and cum_selected equal; params, trust and the metrics within 1e-5
    (fp32 matmuls and the aggregation's sums in other orders; the int8
    codes of the two are the same, up to a rounding flip that moves a
    coordinate by one quant step times lr); the team's theta and the
    slot's thetas within THETA_ATOL: theta is arccos(x) with x within
    1e-5 of 1 here, where one fp32 ulp of x moves theta by ~1.5e-5, and
    the two packages' x differ by a few ulps;
  * an election that selects (``tests/test_torch_pod_robust.py``);
  * the JAX tests' own checks on the port: the loss decreases, a
    zero-trust client out of the team moves no param, the fed state
    round-trips through the step;
  * ``pod.run(driver="scan")`` bitwise ``driver="python"`` on the CPU, and
    the options that wait for a later item raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import ARCHS as JARCHS
from repro.core import pod as jpod
from repro.data import synthetic as jsynthetic
from repro.models import transformer as jtransformer
from repro.optim import optimizers as jopt
from repro_torch import interop, tree
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.core import pod
from repro_torch.models import transformer
from repro_torch.optim import optimizers

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab_size=128, head_dim=16)
JCFG = JARCHS["tiny-lm"].replace(**SMALL)
CFG = ARCHS["tiny-lm"].replace(**SMALL)
C, B, S = 4, 8, 32
ATOL = 1e-5
THETA_ATOL = 5e-4
KEY = jax.random.PRNGKey(0)
SGD = dict(global_batch=B, seq_len=S, lr=1e-2, warmup_steps=1,
           total_steps=4, optimizer="sgd")


def _np_batch(seed):
    toks = np.asarray(jsynthetic.make_lm_tokens(
        jax.random.PRNGKey(seed), B, S + 1, JCFG.vocab_size, n_latent=2))
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models here are tiny: one intra-op thread keeps the suite's
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree_util.tree_map(np.asarray,
                                  jtransformer.init_transformer(KEY, JCFG))


def _port_state(jp, fed, tc):
    opt_init, _ = optimizers.make_optimizer(tc)
    return pod.init_pod_state(interop.params_from_numpy(jp), opt_init, C,
                              fed, torch.Generator().manual_seed(0))


def _both(jp, fed_kw, robust, steps=2):
    """``steps`` steps of both packages from the same init and batches:
    [(jax state, jax metrics, port state, port metrics)]."""
    jfed, fed = JFedConfig(n_clients=C, **fed_kw), FedConfig(n_clients=C,
                                                             **fed_kw)
    jtc, tc = JTrainConfig(**SGD), TrainConfig(**SGD)
    j_init, _ = jopt.make_optimizer(jtc)
    js = jpod.init_pod_state(jax.tree_util.tree_map(jnp.asarray, jp),
                             j_init, C, jfed, KEY)
    jstep = jax.jit(jpod.make_train_step(JCFG, jfed, jtc, robust=robust))
    ps = _port_state(jp, fed, tc)
    pstep = pod.make_train_step(CFG, fed, tc, robust=robust)
    out = []
    for i in range(steps):
        b = _np_batch(i)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ps, pm = pstep(ps, _t(b))
        out.append((js, jm, ps, pm))
    return out


def _check(runs, trust_atol=ATOL):
    for step, (js, jm, ps, pm) in enumerate(runs, start=1):
        jf, pf = js.fed, ps.fed
        for name in ("team", "cum_selected"):
            np.testing.assert_array_equal(getattr(pf, name).numpy(),
                                          np.asarray(getattr(jf, name)),
                                          err_msg=f"{name}, step {step}")
        assert bool(pf.h) == bool(jf.h), step
        assert int(pf.round) == int(jf.round) == step + 1
        assert int(ps.step) == int(js.step) == step
        assert int(pf.slot.p) == int(jf.slot.p), step
        for name in ("prev_theta", "theta_ema", "theta_var"):
            np.testing.assert_allclose(float(getattr(pf.slot, name)),
                                       float(getattr(jf.slot, name)),
                                       atol=THETA_ATOL, err_msg=name)
        np.testing.assert_allclose(pf.trust.numpy(), np.asarray(jf.trust),
                                   atol=trust_atol, err_msg=f"step {step}")
        for a, b in zip(tree.leaves(ps.params),
                        jax.tree_util.tree_leaves(js.params)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                       err_msg=f"params, step {step}")
        assert sorted(pm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(
                float(pm[k]), float(jm[k]), rtol=1e-5,
                atol=THETA_ATOL if k == "theta_team" else ATOL, err_msg=k)


@pytest.mark.parametrize("robust,fed_kw", [
    (None, {}),
    ("per_client", dict(aggregator="fedavg")),
    ("per_client", dict(aggregator="trimmed_mean")),
], ids=["weighted", "fedavg", "trimmed_mean"])
def test_pod_step_matches_jax(jparams, robust, fed_kw):
    check_against_jax(jparams, robust, fed_kw)


def check_against_jax(jp, robust, fed_kw):
    """Two steps of both packages held together (``_check``); with a codec
    also the EF rows' shape and the uplink bytes."""
    runs = _both(jp, fed_kw, robust)
    _check(runs)
    ps = runs[-1][2]
    if "compress" in fed_kw:
        assert ps.fed.ef.shape == (C, sum(p.numel()
                                          for p in tree.leaves(ps.params)))
        assert float(runs[-1][3]["comm_bytes_up"]) == float(
            runs[-1][1]["comm_bytes_up"])


def _state(fed, tc, seed=0):
    params = transformer.init_transformer(torch.Generator().manual_seed(seed),
                                          CFG)
    opt_init, _ = optimizers.make_optimizer(tc)
    return pod.init_pod_state(params, opt_init, C, fed,
                              torch.Generator().manual_seed(seed + 1))


def test_loss_decreases():
    fed = FedConfig(n_clients=C)
    tc = TrainConfig(global_batch=B, seq_len=S, lr=1e-2, warmup_steps=2,
                     total_steps=30)
    state = _state(fed, tc)
    step = pod.make_train_step(CFG, fed, tc)
    batches = [_t(_np_batch(i)) for i in range(4)]
    losses = []
    for i in range(20):
        state, m = step(state, batches[i % 4])
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses[:3] + losses[-3:]


def test_robust_path_keeps_dims_and_is_finite():
    fed = FedConfig(n_clients=C, aggregator="median")
    tc = TrainConfig(global_batch=B, seq_len=S, total_steps=4,
                     warmup_steps=1)
    state = _state(fed, tc)
    state2, m = pod.make_train_step(CFG, fed, tc, robust="per_client")(
        state, _t(_np_batch(0)))
    assert np.isfinite(float(m["loss"]))
    for a, b in zip(tree.leaves(state.params), tree.leaves(state2.params)):
        assert a.shape == b.shape


def test_fed_state_round_trips_through_step():
    fed = FedConfig(n_clients=C, msl=2, pft=1)
    tc = TrainConfig(global_batch=B, seq_len=S, total_steps=8,
                     warmup_steps=1)
    state = _state(fed, tc)
    step = pod.make_train_step(CFG, fed, tc)
    rounds = []
    for i in range(4):
        state, _ = step(state, _t(_np_batch(i)))
        rounds.append(int(state.fed.round))
    assert rounds == [2, 3, 4, 5]
    assert state.fed.team.shape == (C,)
    assert float(state.fed.team.sum()) >= 1.0
    assert 0.0 <= float(state.fed.alpha) <= 1.0


def test_zero_trust_client_does_not_move_params():
    """A client with trust=0 (and out of the team) contributes nothing."""
    fed = FedConfig(n_clients=C, dynamic_alpha=False)
    tc = TrainConfig(global_batch=B, seq_len=S, lr=1e-2, warmup_steps=1,
                     total_steps=4, grad_clip=0.0)
    state = _state(fed, tc)
    state = state._replace(fed=state.fed._replace(
        team=torch.tensor([0.0, 1.0, 1.0, 1.0]),
        trust=torch.tensor([0.0, 1.0, 1.0, 1.0]), h=torch.tensor(False)))
    step = pod.make_train_step(CFG, fed, tc)
    batch = _t(_np_batch(0))
    state_a, _ = step(state, batch)
    bc = B // C
    tok2 = batch["tokens"].clone()
    tok2[:bc] = (tok2[:bc] + 17) % CFG.vocab_size
    state_b, _ = step(state, {"tokens": tok2, "targets": batch["targets"]})
    for a, b in zip(tree.leaves(state_a.params), tree.leaves(state_b.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


@pytest.mark.parametrize("fed_kw", [dict(aggregator="trimmed_mean"),
                                    dict(compress="int8", explore_eps=0.3)],
                         ids=["trimmed_mean", "int8_explore"])
def test_run_scan_matches_python_bitwise(fed_kw):
    """``pod.run`` through the chunked driver (eager on the CPU) against the
    per-step loop: every state tensor, the generator and every history
    value bit for bit, chunks of 2 over 5 steps (the last partial)."""
    fed = FedConfig(n_clients=C, **fed_kw)
    tc = TrainConfig(global_batch=B, seq_len=S, total_steps=5,
                     warmup_steps=1)
    step = pod.make_train_step(CFG, fed, tc, robust="per_client")
    batches = {t: _t(_np_batch(t)) for t in range(5)}
    runs = [pod.run(_state(fed, tc), step, batches.__getitem__, 5,
                    driver=drv, chunk_rounds=2) for drv in ("python", "scan")]
    (sa, ha), (sb, hb) = runs
    assert [r["step"] for r in hb] == [r["step"] for r in ha] == list(
        range(5))
    for ra, rb in zip(ha, hb):
        for k, v in ra.items():
            if k in ("wall_ms", "chunk_ms", "step"):
                continue
            assert np.asarray(v).tobytes() == np.asarray(rb[k]).tobytes(), k
    for x, y in zip(tree.leaves(sa), tree.leaves(sb)):
        if isinstance(x, torch.Generator):
            x, y = x.get_state(), y.get_state()
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)


def test_unported_options_raise():
    fed = FedConfig(n_clients=C)
    tc = TrainConfig(global_batch=B, seq_len=S)
    # ZeRO-1 is ported: the step builds (tests/test_torch_zero1.py runs it)
    assert callable(pod.make_train_step(CFG, fed, tc,
                                        zero1_shardings=(None, None)))
    with pytest.raises(ValueError, match="robust=None"):
        pod.make_train_step(CFG, fed, tc, robust="per_client",
                            zero1_shardings=(None, None))
    with pytest.raises(ValueError, match="per_client"):
        pod.make_train_step(CFG, FedConfig(n_clients=C, compress="int8"), tc)
