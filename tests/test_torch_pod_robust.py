"""The port's PodEngine against the JAX package's ``make_train_step``: the
robust aggregators median and krum, int8 with error feedback (the
fused-dequant path), and an election that selects.  The helpers, the
config and the tolerances are ``tests/test_torch_pod.py``'s (see its
docstring); this file holds the cases that would make that one the
suite's long pole.

  * two steps under median, krum and int8 + EF, with ``optimizer="sgd"``:
    as in ``tests/test_torch_pod.py``;
  * an election that selects (alpha 0, beta 0: the team is the clients at
    or above the mean theta), three steps: teams and h equal; trust within
    1e-3, since theta is arccos of a value near 1, whose slope
    1/sqrt(1 - x^2) amplifies the loss's rounding.
"""
import pytest

from test_torch_pod import (C, _both, _check, _one_thread,  # noqa: F401
                            check_against_jax, jparams)


@pytest.mark.parametrize("fed_kw", [
    dict(aggregator="median"), dict(aggregator="krum"),
    dict(aggregator="trimmed_mean", compress="int8", error_feedback=True),
], ids=["median", "krum", "int8_ef"])
def test_pod_step_matches_jax(jparams, fed_kw):
    check_against_jax(jparams, "per_client", fed_kw)


def test_pod_election_matches_jax(jparams):
    runs = _both(jparams, dict(aggregator="trimmed_mean", beta=0.0,
                               dynamic_alpha=False, alpha=0.0, msl=2, pft=1),
                 "per_client", steps=3)
    assert any(float(r[2].fed.team.sum()) < C for r in runs)   # it selects
    _check(runs, trust_atol=1e-3)
