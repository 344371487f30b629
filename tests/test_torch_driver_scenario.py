"""The chunked driver on two registry cells through ``run_scenario`` (one
sync with a noisy attack, one async): scan bitwise the per-round loop on
the CPU, and the same summary.  One of the nine files of
``tests/test_torch_driver.py``'s cases (see its docstring).
"""
import pytest
import torch

from repro_torch.scenarios import run_scenario
from torch_driver_cases import K, _bitwise, one_thread  # noqa: F401


@pytest.mark.parametrize("cell", ["hetero_fedfits+gaussian",
                                  "async_late_poison"])
def test_run_scenario_scan_matches_python_bitwise(cell):
    from repro_torch.scenarios import registry
    base, _, attack = cell.partition("+")
    sc = registry.get(base)
    if attack:
        sc = sc.replace(attack=attack, attack_scale=0.05)
    kw = dict(n_clients=K, n_rounds=5, n=480, device="cpu")
    (s_py, h_py), (s_sc, h_sc) = [
        run_scenario(sc, driver=drv, chunk_rounds=2, **kw)
        for drv in ("python", "scan")]
    _bitwise((torch.zeros(()), h_sc), (torch.zeros(()), h_py))
    for k, v in s_py.items():
        if k != "wall_s":
            assert s_sc[k] == v, k
