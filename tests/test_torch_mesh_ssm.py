"""The port's sharded trainer against the reference's, on the CPU, for
the hybrid and SSM families: reduced ``hymba-1.5b`` (sliding-window
attention beside a Mamba-2 mixer) and ``mamba2-130m`` on a 2 x 2
``fsdp_tp`` mesh, as ``tests/test_torch_mesh_dense.py`` holds the dense
ones (``tests/mesh_ranks.py``: 4 gloo ranks against the reference's
Auto-axes mesh of 4 host devices; loss and ``grad_norm`` of two steps and
every param after).  The Mamba ``in_proj`` is sharded over "model" by
columns, which cut across z / x / B / C / dt: the slices redistribute and
the scan (``ops.ssd`` rank-local) gets whole heads.
"""

import pytest

import mesh_ranks as mr

CASES = ["train:hymba-1.5b:2:2:fsdp_tp", "train:mamba2-130m:2:2:fsdp_tp"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_ssm")
    mr.write_inputs(d, sorted({c.split(":")[1] for c in CASES}))
    mr.run_sides(d, CASES, CASES)
    return d


@pytest.mark.parametrize("case", CASES)
def test_sharded_steps_match_reference_mesh(runs, case):
    got, want = mr.result(runs, "port", case), mr.result(runs, "ref", case)
    assert len(got["loss"]) == 2
    mr.assert_close_metrics(got, want)
    mr.assert_ranks_agree(got)
    mr.assert_close_params(got, want)
