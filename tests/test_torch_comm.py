"""The port's compressed uplink (repro_torch/comm/) against the JAX
package's (repro/comm/) on the same numpy inputs: the codecs' wire records
and decodes, byte accounting, error feedback, and the fused-dequant
aggregation K6a-c (plain versions on the CPU) against the Pallas kernels
run in interpret mode; then the port's own contracts: fused dequant is
bitwise decode-then-aggregate, an empty cohort gives a zero update, the
gate works on the codes, and a non-finite client leaves params finite.

The test tree is tests/test_comm.py's: ragged leaves of 91, 301, 5 and 512
coords, made with numpy.  JAX records reach the port through
``interop.wire_from_numpy``.

Tolerances: codes, scales (int8/int4), packed bits, kept top-k sets,
decodes, residuals, wire bytes, gate masks and Krum winners are exact.
The exact reference is JAX's codec run eagerly, as written: under
``jax.jit`` XLA on the CPU turns ``amax / levels`` into a multiply by the
reciprocal, which moves about 3% of the scales by one ulp (ROADMAP
queue 3).
signSGD's per-block mean |x| sums 64 or 128 terms in another order, so it
is held at rtol 1e-6.  Sums over columns and clients (cosine partials,
means, trimmed means, distances) at rtol 1e-5 / atol 1e-6; the median
bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jcodecs, error_feedback as jef
from repro.comm.kernels import comm_codecs as jdq
from repro.kernels import robust_pipeline as jrp
from repro_torch import interop, tree
from repro_torch.comm import codecs, error_feedback
from repro_torch.comm.kernels import comm_codecs as dq
from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_models import CNN_CONFIG
from repro_torch.core import aggregation, fedfits
from repro_torch.data.pipeline import build_federation
from repro_torch.kernels import robust_pipeline as rp
from repro_torch.models.model import build

KEY = jax.random.PRNGKey(0)
AGGS = ["fedavg", "median", "trimmed_mean", "krum"]
RTOL, ATOL = 1e-5, 1e-6
SHAPES = {"a": (13, 7), "b": (301,), "c": (5,), "d": (512,)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # tiny CPU models under six test workers: one intra-op thread each
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(c, seed=0, scale=1.0):
    rng = np.random.default_rng(seed + 31 * c)
    return {k: (scale * rng.standard_normal((c, *s))).astype(np.float32)
            for k, s in SHAPES.items()}


def _flat(t):
    """(K, N) numpy matrix of a tree, leaves side by side in JAX's order,
    and the leaf sizes."""
    ls = [np.asarray(l) for l in tree.leaves(t)]
    return (np.concatenate([l.reshape(l.shape[0], -1) for l in ls], 1),
            [int(np.prod(l.shape[1:])) for l in ls])


def _j(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- codecs --
@pytest.mark.parametrize("qblk", [64, 128])
@pytest.mark.parametrize("c", [6, 9])
@pytest.mark.parametrize("name", ["int8", "int4", "signsgd", "topk"])
def test_records_decodes_and_bytes_match_jax(name, c, qblk):
    t = _np_tree(c)
    x, sizes = _flat(t)
    layout = codecs.WireLayout(sizes, qblk)
    jcodec = jcodecs.Codec(name, qblk=qblk)
    codec = codecs.Codec(name, qblk=qblk)
    jenc = jcodec.encode_tree(_j(t))         # eager: see the docstring
    ref = interop.wire_from_numpy(_np(jenc))
    enc = codec.encode_flat(_t(x), layout)
    assert type(enc) is type(ref)
    for f, a, b in zip(ref._fields, enc, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if name == "signsgd" and f == "s":
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
        elif name != "topk":
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
    if name == "topk":       # distinct magnitudes: the same kept coords and
        # values, whatever their order on the wire
        np.testing.assert_array_equal(codec.decode_flat(enc, layout).numpy(),
                                      codec.decode_flat(ref, layout).numpy())
    # the decode of JAX's own record is JAX's decode, bit for bit
    jdec, _ = _flat(_np(jax.jit(jcodec.decode_tree)(jenc, _j(t))))
    np.testing.assert_array_equal(codec.decode_flat(ref, layout).numpy(),
                                  jdec)
    assert codecs.wire_bytes_per_client(enc) == \
        jcodecs.wire_bytes_per_client(jenc)
    # one leaf, and a tree of leaves, through the per-leaf API
    leaf = codec.decode(codec.encode(_t(t["b"])), _t(t["b"]))
    b = jnp.asarray(t["b"])
    np.testing.assert_allclose(
        leaf.numpy(),
        np.asarray(jax.jit(jcodec.decode)(jcodec.encode(b), b)),
        rtol=1e-6 if name == "signsgd" else 0, atol=0)
    back = codec.decode_tree(codec.encode_tree(tree.map(_t, t)),
                             tree.map(_t, t))
    np.testing.assert_array_equal(_flat(back)[0],
                                  codec.decode_flat(enc, layout).numpy())


@pytest.mark.parametrize("c", [6, 9])
def test_randk_is_a_pure_function_of_jax_indices(c):
    t = _np_tree(c)
    x, sizes = _flat(t)
    layout = codecs.WireLayout(sizes, 128)
    jcodec, codec = jcodecs.Codec("randk"), codecs.Codec("randk")
    jenc = jax.jit(jcodec.encode_tree)(_j(t), rng=KEY)
    ref = interop.wire_from_numpy(_np(jenc))
    idx, val = codecs.sparse_encode(_t(x), layout, ref.idx, codec.topk_frac)
    np.testing.assert_array_equal(val.numpy(), ref.val.numpy())
    jdec, _ = _flat(_np(jax.jit(jcodec.decode_tree)(jenc, _j(t))))
    np.testing.assert_array_equal(
        codec.decode_flat(codecs.SparseLeaf(idx, val), layout).numpy(), jdec)
    # the port's own draw: k_l distinct coords of each leaf, JAX's bytes
    enc = codec.encode_flat(_t(x), layout, torch.Generator().manual_seed(3))
    assert codecs.wire_bytes_per_client(enc) == \
        jcodecs.wire_bytes_per_client(jenc)
    with pytest.raises(ValueError):
        codec.encode_flat(_t(x), layout)
    start = 0
    for n, k in zip(sizes, codecs._kept(layout, codec.topk_frac)):
        part = enc.idx[:, start:start + k]
        assert all(len(set(r.tolist())) == k for r in part)
        assert int(part.min()) >= 0 and int(part.max()) < n
        start += k


def test_pack_unpack_and_bits_exact():
    rng = np.random.default_rng(5)
    q = rng.integers(-7, 8, (3, 11)).astype(np.int8)
    p = codecs.pack_int4(_t(q))
    ref = jcodecs.pack_int4(jnp.asarray(q))
    np.testing.assert_array_equal(p.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(codecs.unpack_int4(p, 11).numpy(), q)
    b = (rng.uniform(size=(4, 21)) > 0.5).astype(np.uint8)
    p = codecs.pack_bits(_t(b))
    ref = jcodecs.pack_bits(jnp.asarray(b))
    np.testing.assert_array_equal(p.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(codecs.unpack_bits(p, 21).numpy(), b)


@pytest.mark.parametrize("weighted", [False, True])
def test_majority_vote_exact(weighted):
    c, qblk = 9, 64
    t = _np_tree(c, seed=2)
    t["b"][:3] *= -1.0                                 # a flipped minority
    layout = codecs.WireLayout(_flat(t)[1], qblk)
    mask = np.ones(c, np.float32)
    mask[4] = 0.0
    w = np.arange(1, c + 1, dtype=np.float32) if weighted else None
    jcodec = jcodecs.Codec("signsgd", qblk=qblk)
    jenc = jax.jit(jcodec.encode_tree)(_j(t))
    enc = interop.wire_from_numpy(_np(jenc))
    out = codecs.majority_vote(enc, layout, _t(mask),
                               None if w is None else _t(w))
    ref = np.concatenate([np.asarray(jcodecs.majority_vote(
        jenc[k], int(np.prod(SHAPES[k])), qblk, jnp.asarray(mask),
        None if w is None else jnp.asarray(w))) for k in sorted(t)])
    np.testing.assert_array_equal(out.numpy(), ref)


# --------------------------------------------------------- error feedback --
@pytest.mark.parametrize("name", ["int8", "int4", "topk"])
def test_error_feedback_matches_jax_over_rounds(name):
    c = 6
    codec, jcodec = codecs.Codec(name, qblk=64), jcodecs.Codec(name, qblk=64)
    x, sizes = _flat(_np_tree(c))
    layout = codecs.WireLayout(sizes, 64)
    res = error_feedback.init(_t(x))
    jres = jef.init(_j(_np_tree(c)))
    for r in range(3):
        u = _np_tree(c, seed=10 + r, scale=0.1)
        enc, dec, res = error_feedback.compress(codec, _t(_flat(u)[0]),
                                                layout, res)
        jenc, jdec, jres = jef.compress(jcodec, _j(u), jres)
        np.testing.assert_array_equal(dec.numpy(), _flat(_np(jdec))[0])
        np.testing.assert_array_equal(
            res.numpy(), interop.rows_from_numpy(_np(jres)).numpy())
    assert error_feedback.compress(codec, _t(x), layout)[2] is None


# ------------------------------------------------- fused dequant kernels --
def _wire_pair(c, qblk, tie=False):
    """One cohort's int8 record of the test tree: JAX's per-leaf (1, C,
    n_l) codes and (1, C, nq_l) scales, and the port's (1, C, N), (1, C,
    NQ) record converted from them.  ``tie``: client 3 a copy of client 2,
    so that every column holds a tie."""
    g = 1
    t = _np_tree(c, seed=4, scale=0.05)
    if tie:
        for leaf in t.values():
            leaf[3] = leaf[2]
    jenc = jax.jit(jcodecs.Codec("int8", qblk=qblk).encode_tree)(_j(t))
    leaves = jax.tree_util.tree_flatten(jenc, is_leaf=jcodecs.is_encoded)[0]
    jq = [e.q.reshape(g, c, -1) for e in leaves]
    js = [e.s.reshape(g, c, -1) for e in leaves]
    enc = interop.wire_from_numpy(_np(jenc))
    layout = codecs.WireLayout(_flat(t)[1], qblk)
    return jq, js, enc.q.view(g, c, -1), enc.s.view(g, c, -1), layout


def _masks(c):
    mask = np.ones((1, c), np.float32)
    mask[0, [1, c - 1]] = 0.0
    w = np.random.default_rng(c).uniform(0.1, 1.0, (1, c)).astype(np.float32)
    w *= mask
    return mask, w / w.sum(1, keepdims=True)


@pytest.mark.parametrize("qblk", [64, 128])
@pytest.mark.parametrize("c", [6, 9])
def test_dequant_kernels_match_pallas(c, qblk):
    jq, js, q, s, layout = _wire_pair(c, qblk)
    mask, w = _masks(c)
    kw = dict(qblk=qblk, blk=128, interpret=True)
    ones = jnp.ones((len(jq),))
    keep = mask > 0

    ref = jdq.dequant_gate_partials(jq, js, jnp.asarray(mask), leaf_scale=ones,
                                    **kw)
    out = dq.dequant_gate_partials(q, s, layout, _t(mask))
    for o, r in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(o.numpy()[keep], np.asarray(r)[keep],
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), rtol=RTOL,
                               atol=ATOL)
    for thresh in (-0.5, 0.0):
        np.testing.assert_array_equal(
            rp._resolve_gate(*out, _t(mask), thresh).numpy(),
            np.asarray(jrp._resolve_gate(*ref, jnp.asarray(mask), thresh)))

    for mode in ("mean", "trimmed", "median"):
        wm = w if mode == "mean" else mask
        ref = np.concatenate([np.asarray(o) for o in jdq.dequant_gated_combine(
            jq, js, jnp.asarray(mask), jnp.asarray(wm), mode=mode,
            trim_frac=0.2, out_dtypes=[jnp.float32] * len(jq), **kw)], 1)
        out = dq.dequant_gated_combine(q, s, layout, _t(mask), _t(wm),
                                       mode=mode, trim_frac=0.2).numpy()
        if mode == "median":
            np.testing.assert_array_equal(out, ref)
        else:
            np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)

    ref = np.asarray(jdq.dequant_pairwise_sq_dists(
        jq, js, jnp.asarray(mask), leaf_scale=ones, **kw))
    d = rp.sq_dists_from_gram(dq.dequant_pairwise_gram(q, s, layout,
                                                       _t(mask)), _t(mask))
    pair = keep[:, :, None] & keep[:, None, :] & ~np.eye(c, dtype=bool)[None]
    np.testing.assert_allclose(d.numpy()[pair], ref[pair], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(
        rp._krum_weights(d, _t(mask), 1, 1).numpy(),
        np.asarray(jrp._krum_weights(jnp.asarray(ref), jnp.asarray(mask), 1,
                                     1)))


@pytest.mark.parametrize("c", [17, 32, 33, 48, 64, 65])
def test_dequant_gate_partials_matches_pallas_at_bucket_edges(c):
    """K6a past the 16-row bucket, at the edges of pass 1's register
    buckets (32, 64) and past them, with two masked-out rows and a tie in
    every column: the partials of the masked-in rows and refsq against the
    Pallas kernel in interpret mode, and the gate on them exactly."""
    jq, js, q, s, layout = _wire_pair(c, 128, tie=True)
    mask, _ = _masks(c)
    keep = mask > 0
    ref = jdq.dequant_gate_partials(jq, js, jnp.asarray(mask),
                                    leaf_scale=jnp.ones((len(jq),)),
                                    qblk=128, blk=128, interpret=True)
    out = dq.dequant_gate_partials(q, s, layout, _t(mask))
    for o, r in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(o.numpy()[keep], np.asarray(r)[keep],
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), rtol=RTOL,
                               atol=ATOL)
    for thresh in (-0.5, 0.0):
        np.testing.assert_array_equal(
            rp._resolve_gate(*out, _t(mask), thresh).numpy(),
            np.asarray(jrp._resolve_gate(*ref, jnp.asarray(mask), thresh)))


def _record(c, comp="int8", seed=0):
    t = tree.map(_t, _np_tree(c, seed=seed, scale=0.05))
    x, sizes = _flat(tree.map(lambda l: l.numpy(), t))
    codec = codecs.Codec(comp)
    layout = codec.layout(sizes)
    enc = codec.encode_flat(_t(x), layout, torch.Generator().manual_seed(0))
    dec = tree.row_views(codec.decode_flat(enc, layout),
                         tree.map(lambda l: l[0], t))
    return codec, layout, enc, dec, tree.map(lambda l: l[0], t)


@pytest.mark.parametrize("agg", AGGS)
def test_fused_dequant_is_bitwise_decode_then_aggregate(agg):
    c = 9
    codec, layout, enc, dec, like = _record(c)
    mask = torch.ones(c)
    mask[3] = 0.0
    w = torch.linspace(0.2, 1.0, c)
    cfg = FedConfig(n_clients=c, aggregator=agg, compress="int8")
    assert dq.should_fuse(codec, cfg)
    out = dq.fused_dequant_aggregate_tree(enc, layout, w, mask, cfg,
                                          like=like)
    ref = aggregation.aggregate(dec, w, mask, cfg)
    for o, r in zip(tree.leaves(out), tree.leaves(ref)):
        assert torch.equal(o, r)


@pytest.mark.parametrize("comp", ["int8", "int4", "signsgd", "topk",
                                  "randk"])
def test_empty_cohort_gives_zero_update(comp):
    c = 6
    codec, layout, enc, dec, like = _record(c, comp)
    cfg = FedConfig(n_clients=c, aggregator="trimmed_mean", compress=comp)
    zero = torch.zeros(c)
    out = aggregation.aggregate(dec, torch.ones(c), zero, cfg)
    assert all(not bool(l.any()) for l in tree.leaves(out))
    if comp == "int8":
        out = dq.fused_dequant_aggregate_tree(enc, layout, torch.ones(c), zero,
                                              cfg, like=like)
        assert all(not bool(l.any()) for l in tree.leaves(out))


def test_gate_excises_sign_flipped_clients_on_the_codes():
    c = 8
    rng = np.random.default_rng(0)
    honest = rng.standard_normal((c, 256)).astype(np.float32) * 0.01 + 1.0
    honest[:2] = -50.0
    codec = codecs.Codec("int8")
    layout = codec.layout([256])
    enc = codec.encode_flat(_t(honest), layout)
    cfg = FedConfig(n_clients=c, aggregator="median", compress="int8")
    out = dq.fused_dequant_aggregate_tree(enc, layout, torch.ones(c),
                                          torch.ones(c), cfg,
                                          like={"w": torch.zeros(256)})
    assert bool((out["w"] > 0.5).all())


def test_wrappers_check_and_count_on_the_cpu():
    """The wrappers refuse codes that are not int8, scales that are not
    fp32 and shapes off the layout; on a CPU tensor the plain version runs
    and no launch is counted."""
    codec, layout, enc, _, _ = _record(6)
    q, s = enc.q[None], enc.s[None]
    m = torch.ones(1, 6)
    with pytest.raises(TypeError):
        dq.dequant_gate_partials(q.to(torch.int16), s, layout, m)
    with pytest.raises(TypeError):
        dq.dequant_gated_combine(q, s.double(), layout, m, m, mode="mean")
    with pytest.raises(ValueError):
        dq.dequant_pairwise_gram(q[:, :, :-1], s, layout, m)
    dq.reset_launch_counts()
    dq.fused_dequant_pipeline(q, s, layout, m, m, aggregator="krum")
    assert set(dq.launch_counts().values()) == {0}


# ------------------------------------------------------------- the round --
@pytest.mark.parametrize("aggregator", ["fedavg", "krum"])
def test_nonfinite_client_leaves_params_finite(aggregator):
    """Client 0's EF residual holds inf (its scales become inf, its decode
    NaN, the guard rejects it) and client 1's holds NaN (its codes there
    are 0).  Params stay finite, and bitwise the same with the fused
    dequant on and off."""
    model = build(CNN_CONFIG.replace(d_model=4, d_ff=16))
    fed, _ = build_federation(0, n=600, n_clients=6, batch_size=16,
                              device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    finals = []
    for fused in (True, False):
        cfg = FedConfig(n_clients=6, local_epochs=2, local_lr=0.05, msl=4,
                        pft=2, aggregator=aggregator, compress="int8",
                        fused_dequant=fused)
        state = fedfits.init_state(params, 6, cfg, torch.Generator())
        assert [tuple(l.shape) for l in tree.leaves(state.ef)] == \
            [(6, *p.shape) for p in tree.leaves(params)]
        state.clients.ef[0, 100:300] = float("inf")
        state.clients.ef[1, 40:50] = float("nan")
        f = fedfits.make_round(model, cfg)
        gen = torch.Generator().manual_seed(1)
        rejected = []
        for t in range(2):
            state, m = f(state, fed.data_fn(t + 1, gen))
            rejected.append(float(m["guard_rejected"]))
        assert rejected[0] == 1.0
        assert all(bool(torch.isfinite(l).all())
                   for l in tree.leaves(state.params))
        finals.append(state.params)
    for a, b in zip(*map(tree.leaves, finals)):
        assert torch.equal(a, b)
