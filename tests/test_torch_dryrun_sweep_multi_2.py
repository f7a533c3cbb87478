"""The dry run's sweep on the multi-pod (2, 16, 16) mesh, part 2 of 3
(the cuts and checks of ``tests/test_torch_dryrun_sweep.py``)."""

import pytest

from test_torch_dryrun_sweep import check_cell, multi_part


@pytest.mark.parametrize("arch,shape", multi_part(2))
def test_multi_pod_cell_traces(arch, shape, tmp_path):
    check_cell(arch, shape, "multi", tmp_path)
