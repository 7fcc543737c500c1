"""The port's sharded trainer against the reference's, on the CPU, for
the dense, sliding-window and encoder families.

The port's ``make_train_step`` with a runtime on DTensors, on 4 gloo
ranks spawned in one process, against the reference's jitted train step
on an Auto-axes mesh of 4 host devices in another
(``tests/mesh_ranks.py``), from the same weights (the reference's
``init_params`` carried across with ``params_from_numpy``) on the same
numpy batches: two steps, loss and ``grad_norm`` each step, and every
param after, within the tolerances ``mesh_ranks`` states.  Cases:
reduced ``qwen3-8b`` (TP with FSDP), ``gemma3-4b`` (windows, softcaps,
post norms) and ``hubert-xlarge`` (bidirectional, supervised; its vocab
504 is replicated where the model axis does not divide it) on a 2 x 2
``fsdp_tp`` mesh, and ``qwen3-8b`` on 4 x 1 ``pure_fsdp``.
"""

import pytest

import mesh_ranks as mr

CASES = ["train:qwen3-8b:2:2:fsdp_tp", "train:gemma3-4b:2:2:fsdp_tp",
         "train:hubert-xlarge:2:2:fsdp_tp", "train:qwen3-8b:4:1:pure_fsdp"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_dense")
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
