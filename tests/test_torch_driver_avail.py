"""The chunked driver's sync case ``avail`` (availability draws with explore
0.3): ``fedfits.run(driver="scan")`` bitwise ``driver="python"`` over 7
rounds at ``chunk_rounds`` 1, 3 and 8 on the CPU. One of the nine files of
``tests/test_torch_driver.py``'s cases (see its docstring); the case lives
in ``torch_driver_cases.py``.
"""
import pytest

from torch_driver_cases import (  # noqa: F401
    check_sync_case, one_thread, sync_setup)


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("case", ['avail'])
def test_fedfits_scan_matches_python_bitwise(sync_setup, case, chunk):
    check_sync_case(sync_setup, case, chunk)
