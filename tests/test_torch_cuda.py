"""The port on the card: each CUDA kernel against its plain version, the
wrappers' checks and launch counts, and a round on the card against the
same round on the CPU.  Needs a CUDA device; skips without one.  Imports
no jax, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the median bitwise; per-column sums over clients rtol 1e-5 /
atol 1e-6; sums over ~6.5e4 columns (cosine partials, Gram) at 1e-5 of
the largest magnitude, because the kernel and torch reduce in other
orders.
"""
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_models import CNN_CONFIG
from repro_torch.core import fedfits
from repro_torch.data.pipeline import build_federation
from repro_torch.kernels import robust_pipeline as rp
from repro_torch.models.model import build

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(card, g=3, c=64, n=65573):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((g, c, n), np.float32)
    mask = np.ones((g, c), np.float32)
    mask[0, 5] = 0.0
    mask[1] = 0.0                                  # empty cohort
    mask[2] = 0.0
    mask[2, 7] = 1.0                               # one member
    w = mask / np.maximum(mask.sum(1, keepdims=True), 1.0)
    return (torch.from_numpy(a).to(card) for a in (x, mask, w))


def _close_rel(out, ref):
    tol = 1e-5 * float(ref.abs().max())
    assert float((out - ref).abs().max()) <= tol


def test_kernels_match_plain(card):
    x, m, w = _inputs(card)
    for o, r in zip(rp.cosine_gate_partials(x, m),
                    rp.cosine_gate_partials_plain(x, m)):
        _close_rel(o, r)
    for mode in rp.MODES:
        out = rp.gated_combine(x, m, w, mode=mode)
        ref = rp.gated_combine_plain(x, m, w, mode=mode)
        if mode == "median":
            assert torch.equal(out, ref)
        else:
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
        assert float(out[1].abs().max()) == 0.0
        torch.testing.assert_close(out[2], x[2, 7], rtol=1e-5, atol=1e-6)
    _close_rel(rp.pairwise_gram(x), rp.pairwise_gram_plain(x))


def test_wrappers_check_and_count(card):
    x, m, w = _inputs(card, c=8, n=1000)
    rp.reset_launch_counts()
    rp.fused_pipeline(x, w, m, aggregator="krum")
    assert rp.launch_counts() == {
        "cosine_gate_partials": 1, "pairwise_gram": 1,
        "gated_combine[mean]": 1, "gated_combine[trimmed]": 0,
        "gated_combine[median]": 0}
    with pytest.raises(TypeError):
        rp.cosine_gate_partials(x.double(), m)
    with pytest.raises(ValueError):
        rp.gated_combine(x.transpose(1, 2), m, w, mode="mean")
    with pytest.raises(ValueError):
        rp.pairwise_gram(torch.zeros(1, 65, 10, device=card))


@pytest.mark.parametrize("aggregator", ["fedavg", "trimmed_mean", "krum"])
def test_round_on_card_matches_cpu(card, aggregator):
    model = build(CNN_CONFIG.replace(d_model=4, d_ff=16))
    cfg = FedConfig(n_clients=6, local_epochs=2, local_lr=0.05, msl=4,
                    pft=2, aggregator=aggregator)
    fed, _ = build_federation(0, n=600, n_clients=6, batch_size=16)
    params = model.init(torch.Generator(card).manual_seed(0))
    cpu = lambda t: tree.map(lambda v: v.cpu(), t)
    s_gpu = fedfits.init_state(params, 6, cfg, torch.Generator(card))
    s_cpu = fedfits.init_state(cpu(params), 6, cfg, torch.Generator())
    f = fedfits.make_round(model, cfg)
    gen = torch.Generator(card).manual_seed(1)
    for t in range(3):
        batch = fed.data_fn(t + 1, gen)
        s_gpu, m_gpu = f(s_gpu, batch)
        s_cpu, m_cpu = f(s_cpu, cpu(batch))
        assert torch.equal(m_gpu["team"].cpu(), m_cpu["team"])
        for a, b in zip(tree.leaves(s_gpu.params), tree.leaves(s_cpu.params)):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)
