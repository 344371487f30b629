"""The serving side of the sharded layouts: ``Model.prefill`` and
``Model.decode`` on params placed by ``param_specs`` and by
``param_specs_tp`` (the dry-run's ``tp_serve``), a cache placed by
``cache_specs`` (a KV cache's sequence split over "model") and the batch's
rows split over "data", on gloo meshes of 1 x 2 and 2 x 2 spawned
processes, for the attn, moe, hybrid (ring cache, wrapping) and xlstm
block kinds (``tests/torch_pod_tp_cases.py``): every call's logits within
1e-5 of the largest of the plain call's on every rank.  The cache write
under them (``dtensor.write_run_``) on the same meshes: runs across a
piece boundary, wrapping, the whole length and one slot, each rank
writing its own piece, bitwise the plain write (itself numpy's slot
assignment) with no collective byte counted.

And the three public functions the port lacked, against the JAX
package: ``selection.participation_ratio`` and
``partition.size_skew_partition`` (exact) and the ``krum_multi_m``
argument of ``fused_pipeline`` / ``fused_dequant_pipeline`` at m = 1, 2, 3
(1e-6), with the reference's Pallas kernels in interpret mode.
"""
import numpy as np
import pytest
import torch

import torch_pod_tp_cases as tp

KINDS = sorted(tp.SERVE_KINDS)
VARIANTS = ["baseline", "tp_serve"]
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {name: tp.spawn(shape, [("serve", (k, v)) for k in KINDS
                                   for v in VARIANTS] + [("write", None)],
                           str(tmp_path_factory.mktemp(f"serve_{name}")))
            for name, shape in MESHES.items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind", KINDS)
def test_placed_prefill_decode_match_plain(ranks, mesh, kind, variant):
    ref = tp.run_serve(kind, variant)
    for r, got in ranks[mesh].items():
        tp.check_serve(got["serve", (kind, variant)], ref)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_placed_cache_write_is_local_and_matches_plain(ranks, mesh):
    init, srcs = tp.write_inputs()
    want, n = init.copy(), init.shape[2]
    ref, moved = tp.run_write()
    assert moved == 0
    for (start, length), src, got in zip(tp.WRITE_RUNS, srcs, ref):
        want[:, :, (start + np.arange(length)) % n] = src
        np.testing.assert_array_equal(got, want)
    for r, res in ranks[mesh].items():
        outs, moved = res["write", None]
        assert moved == 0, (r, moved)
        for got, exp in zip(outs, ref):
            np.testing.assert_array_equal(got, exp)


# ------------------------------------------------- the missing functions --
def test_participation_ratio_matches_reference():
    import jax.numpy as jnp
    from repro.core import selection as jsel
    from repro_torch.core import selection
    rng = np.random.default_rng(0)
    for k in (1, 5, 16, 64):
        cum = (rng.integers(0, 3, k) * rng.integers(0, 2, k)).astype(
            np.float32)
        got = selection.participation_ratio(torch.from_numpy(cum))
        want = jsel.participation_ratio(jnp.asarray(cum))
        assert float(got) == float(want)


@pytest.mark.parametrize("n_clients,zipf_a", [(4, 1.3), (16, 1.3),
                                              (10, 0.8), (32, 2.0)])
def test_size_skew_partition_matches_reference(n_clients, zipf_a):
    from repro.data import partition as jpart
    from repro_torch.data import partition
    got = partition.size_skew_partition(np.random.default_rng(5), 1000,
                                        n_clients, zipf_a)
    want = jpart.size_skew_partition(np.random.default_rng(5), 1000,
                                     n_clients, zipf_a)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _krum_inputs():
    rng = np.random.default_rng(11)
    G, C, N = 2, 9, 600
    x = rng.standard_normal((G, C, N)).astype(np.float32)
    x[:, 3] *= 4.0                      # a far row Krum passes over
    w = rng.uniform(0.1, 1.0, (G, C)).astype(np.float32)
    m = np.ones((G, C), np.float32)
    m[1, 5] = 0.0
    return x, w, m


@pytest.mark.parametrize("multi_m", [1, 2, 3])
def test_krum_multi_m_fused_pipeline_matches_reference(multi_m):
    import jax.numpy as jnp
    from repro.kernels import robust_pipeline as jrp
    from repro_torch.kernels import robust_pipeline as rp
    x, w, m = _krum_inputs()
    got = rp.fused_pipeline(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(m), aggregator="krum",
                            krum_multi_m=multi_m)
    want = jrp.fused_pipeline(jnp.asarray(x), jnp.asarray(w), jnp.asarray(m),
                              aggregator="krum", krum_multi_m=multi_m,
                              interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    if multi_m > 1:                     # it changes the aggregate
        one = rp.fused_pipeline(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(m), aggregator="krum")
        assert not np.allclose(one.numpy(), got.numpy(), atol=1e-6)


@pytest.mark.parametrize("multi_m", [1, 2, 3])
def test_krum_multi_m_fused_dequant_pipeline_matches_reference(multi_m):
    import jax.numpy as jnp
    from repro.comm.kernels import comm_codecs as jcc
    from repro_torch.comm import codecs
    from repro_torch.comm.kernels import comm_codecs as cc
    x, w, m = _krum_inputs()
    G, C, N = x.shape
    layout = codecs.WireLayout([N], 128)
    enc = codecs.Codec("int8", qblk=128).encode_flat(
        torch.from_numpy(x.reshape(G * C, N)), layout)
    q = enc.q.reshape(G, C, -1)
    s = enc.s.reshape(G, C, -1)
    got = cc.fused_dequant_pipeline(q, s, layout, torch.from_numpy(w),
                                    torch.from_numpy(m), aggregator="krum",
                                    krum_multi_m=multi_m)
    want = jcc.fused_dequant_pipeline_leafwise(
        [jnp.asarray(q.numpy())], [jnp.asarray(s.numpy())], jnp.asarray(w),
        jnp.asarray(m), aggregator="krum", krum_multi_m=multi_m, qblk=128,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-6)
