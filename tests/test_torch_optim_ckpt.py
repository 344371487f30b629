"""The pod trainer's substrate against the JAX package on the same numpy
inputs: the optimizers (``optim/optimizers.py``), the LM token generator,
the checkpoint format (``checkpoint/checkpoint.py``) and the training
configs and input specs.

  * sgd, adamw (with weight decay), clip_by_global_norm, global_norm and
    warmup_cosine over three updates of the same numpy tree: within 1e-6
    (fp32 elementwise arithmetic; ``jnp`` and torch may fuse a multiply
    and an add differently);
  * ``make_lm_tokens``: the pure function of the draws fed JAX's own draws
    gives JAX's tokens exactly, and the port's own draws keep the latent
    structure (every step one of its chain's 8 candidates);
  * checkpoints: a round trip of a state with fp32, bf16, int32 and bool
    leaves, ``None`` and a generator; a checkpoint written by the JAX
    package (fp32 and bf16 leaves, through ml_dtypes) restored by the
    port, and one written by the port restored by the JAX package.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import base as jbase
from repro.configs.registry import ARCHS as JARCHS
from repro.data import synthetic as jsyn
from repro.launch import inputs as jinputs
from repro.optim import optimizers as jopt
from repro_torch import tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import base
from repro_torch.configs.registry import ARCHS
from repro_torch.data import synthetic
from repro_torch.launch import inputs
from repro_torch.optim import optimizers

ATOL = 1e-6


def _np_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((5, 3), np.float32),
            "b": [rng.standard_normal((7,), np.float32),
                  rng.standard_normal((2, 2, 2), np.float32)]}


def _t(np_tree):
    return tree.map(lambda a: torch.from_numpy(np.array(a)), np_tree)


def _close(port, ref, atol=ATOL):
    for p, r in zip(tree.leaves(port), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=atol,
                                   rtol=0)


@pytest.mark.parametrize("name,wd", [("sgd", 0.0), ("adam", 0.0),
                                     ("adamw", 0.1)])
def test_optimizers_match_jax(name, wd):
    tc = dict(lr=3e-2, warmup_steps=2, total_steps=5, optimizer=name,
              weight_decay=wd, grad_clip=1.0)
    j_init, j_update = jopt.make_optimizer(jbase.TrainConfig(**tc))
    p_init, p_update = optimizers.make_optimizer(base.TrainConfig(**tc))
    jp, pp = _np_tree(0), _t(_np_tree(0))
    js, ps = j_init(jp), p_init(pp)
    for step in range(3):
        g = _np_tree(step + 1)
        jg, jn = jopt.clip_by_global_norm(g, 1.0)
        pg, pn = optimizers.clip_by_global_norm(_t(g), 1.0)
        np.testing.assert_allclose(float(pn), float(jn), rtol=1e-6)
        _close(pg, jg)
        ju, js = j_update(jg, js, jp)
        pu, ps = p_update(pg, ps, pp)
        _close(pu, ju)
        jp = jopt.apply_updates(jp, ju)
        pp = optimizers.apply_updates(pp, pu)
        _close(pp, jp)
        assert ps.count.dtype == torch.int32 and int(ps.count) == step + 1
    _close(ps, js)


def test_global_norm_and_warmup_cosine_match_jax():
    g = _np_tree(3)
    np.testing.assert_allclose(float(optimizers.global_norm(_t(g))),
                               float(jopt.global_norm(g)), rtol=1e-6)
    jlr, plr = jopt.warmup_cosine(3e-4, 5, 40), optimizers.warmup_cosine(
        3e-4, 5, 40)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 60):
        got = plr(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(jlr(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-12)


def _jax_draws(key, n, s, vocab, n_latent):
    """The draws JAX's ``make_lm_tokens`` takes, in its order of keys."""
    kz, kt, kw = jax.random.split(key, 3)
    z = jax.random.randint(kz, (n,), 0, n_latent)
    cand = jax.random.randint(kt, (n_latent, vocab, 8), 0, vocab)

    def per_seq(k):
        k0, ks = jax.random.split(k)
        first = jax.random.randint(k0, (), 0, vocab)
        choice = jax.vmap(lambda kk: jax.random.randint(kk, (), 0, 8))(
            jax.random.split(ks, s - 1))
        return first, choice

    first, choice = jax.vmap(per_seq)(jax.random.split(kw, n))
    return [torch.from_numpy(np.asarray(a, np.int64))
            for a in (z, cand, first, choice)]


def test_lm_tokens_from_jax_draws_are_jax_tokens():
    key = jax.random.PRNGKey(3)
    n, s, vocab, lat = 6, 17, 50, 3
    ref = np.asarray(jsyn.make_lm_tokens(key, n, s, vocab, n_latent=lat))
    got = synthetic.lm_tokens_from_draws(*_jax_draws(key, n, s, vocab, lat))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_make_lm_tokens_keeps_the_latent_structure():
    n, s, vocab, lat = 16, 33, 40, 2
    z, cand, first, choice = synthetic.draw_lm_tokens(
        torch.Generator().manual_seed(5), n, s, vocab, lat)
    toks = synthetic.make_lm_tokens(torch.Generator().manual_seed(5), n, s,
                                    vocab, lat)
    assert toks.shape == (n, s) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < vocab
    assert torch.equal(toks, synthetic.lm_tokens_from_draws(z, cand, first,
                                                            choice))
    assert torch.equal(toks[:, 0], first)
    for i in range(n):                  # each step one of the 8 candidates
        for a, b in zip(toks[i, :-1].tolist(), toks[i, 1:].tolist()):
            assert b in cand[z[i], a].tolist()
    assert int(z.min()) >= 0 and int(z.max()) < lat


def test_checkpoint_round_trip_with_a_generator(tmp_path):
    gen = torch.Generator().manual_seed(11)
    torch.rand(3, generator=gen)
    state = {"w": torch.randn(4, 3), "h": torch.randn(5).bfloat16(),
             "n": torch.tensor(7, dtype=torch.int32),
             "flag": torch.tensor(True), "ef": None,
             "fed": (torch.arange(3.0), gen)}
    ckpt.save_step(str(tmp_path), 4, state)
    want = torch.rand(4, generator=gen)         # the generator moves on
    like_gen = torch.Generator().manual_seed(0)
    like = {"w": torch.zeros(4, 3), "h": torch.zeros(5).bfloat16(),
            "n": torch.tensor(0, dtype=torch.int32),
            "flag": torch.tensor(False), "ef": None,
            "fed": (torch.zeros(3), like_gen)}
    out, step = ckpt.restore_latest(str(tmp_path), like)
    assert step == 4 and ckpt.latest_step(str(tmp_path)) == 4
    for a, b in zip(tree.leaves(out), tree.leaves(state)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert out["ef"] is None and out["fed"][1] is like_gen
    assert torch.equal(torch.rand(4, generator=like_gen), want)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path / "step_00000004"), {"w": like["w"]})


def test_jax_checkpoint_restores_in_the_port_and_back(tmp_path):
    rng = np.random.default_rng(2)
    jtree = {"emb": jnp.asarray(rng.standard_normal((6, 4), np.float32)),
             "layers": [jnp.asarray(rng.standard_normal((3, 5)),
                                    jnp.bfloat16),
                        jnp.asarray(rng.standard_normal((2,), np.float32))]}
    jckpt.save(str(tmp_path / "jax"), jtree, step=9)
    like = {"emb": torch.zeros(6, 4), "layers": [
        torch.zeros(3, 5, dtype=torch.bfloat16), torch.zeros(2)]}
    out = ckpt.restore(str(tmp_path / "jax"), like)
    for a, b in zip(tree.leaves(out), jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == like_dtype(b)
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    # and the port's bf16 leaves read back through ml_dtypes by JAX
    ckpt.save(str(tmp_path / "port"), out, step=9)
    back = jckpt.restore(str(tmp_path / "port"), jtree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def like_dtype(jax_leaf):
    return {jnp.bfloat16: torch.bfloat16}.get(jax_leaf.dtype.type,
                                              torch.float32)


def test_train_configs_and_input_specs_match_jax():
    for name in ("TrainConfig", "MeshConfig"):
        j, p = getattr(jbase, name)(), getattr(base, name)()
        assert dataclasses.asdict(p) == dataclasses.asdict(j), name
    assert base.MeshConfig(pods=2).axis_names == jbase.MeshConfig(
        pods=2).axis_names
    assert base.MeshConfig(pods=2).shape == jbase.MeshConfig(pods=2).shape
    assert {k: dataclasses.asdict(v) for k, v in base.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jbase.INPUT_SHAPES.items()}
    for arch in ("tiny-lm", "minitron-4b"):
        for shape in base.INPUT_SHAPES:
            p = inputs.shape_variant(ARCHS[arch], shape)
            j = jinputs.shape_variant(JARCHS[arch], shape)
            assert (p.loss_chunk, p.sliding_window) == (j.loss_chunk,
                                                        j.sliding_window)
            got = inputs.train_batch_specs(ARCHS[arch], shape)
            ref = jinputs.train_batch_specs(JARCHS[arch], shape)
            assert sorted(got) == sorted(ref)
            for k in ref:
                assert got[k].shape == ref[k].shape
                assert str(got[k].dtype).split(".")[-1] == str(ref[k].dtype)
