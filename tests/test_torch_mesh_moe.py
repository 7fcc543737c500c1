"""The port's ``ep > 1`` MoE dispatch and sharded MoE trainer against the
reference's, on the CPU (``tests/mesh_ranks.py``: 4 gloo ranks against
the reference's Auto-axes mesh of 4 host devices), reduced
``qwen2-moe-a2.7b`` (8 experts stored as 16, top-2, shared experts
behind a gate).

* The layer alone, at ep 2 on a 2 x 2 mesh and at ep 4 on 1 x 4, against
  the reference's ``moe_layer`` under its ``shard_map``, at 4 x 560
  tokens skewed by a shared offset: a data shard of 1,120 (2,240 at data
  1) passes the dropless threshold, so capacity is a data shard's and
  entries drop.  Output and
  aux within MOE_TOL; each data shard's dropped entries equal.
* Two train steps at 2 x 2 (ep 2) and 1 x 4 (ep 4): loss, ``grad_norm``,
  ``moe_aux`` and every param after, within the tolerances
  ``mesh_ranks`` states.  At 2 x 2 the reference's sharded step is not
  its one-device step: its aux is data shard 0's (the ``out_specs=P()``
  of its ``shard_map``), and the port matches that, not the one-device
  value it gives on one process.
"""

import jax
import numpy as np
import pytest

import mesh_ranks as mr

# f32 sums in another order, a value of order 1 (the forward tests'
# bound in tests/test_torch_moe.py)
MOE_TOL = 1e-5
LAYER = ["moe:qwen2-moe-a2.7b:2:2:fsdp_tp", "moe:qwen2-moe-a2.7b:1:4:fsdp_tp"]
TRAIN = ["train:qwen2-moe-a2.7b:2:2:fsdp_tp",
         "train:qwen2-moe-a2.7b:1:4:fsdp_tp"]
ONE = "train:qwen2-moe-a2.7b:1:1:fsdp_tp"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro.configs import get_config
    from repro.models import moe
    d = tmp_path_factory.mktemp("mesh_moe")
    mr.write_inputs(d, ["qwen2-moe-a2.7b"])
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    p = moe.init_moe_params(jax.random.PRNGKey(5), cfg, np.float32)
    # one offset shared by every token skews the routing, so that some
    # experts get more than their capacity (tests/test_torch_moe.py)
    rs = np.random.RandomState(6)
    x = (rs.randn(4, 560, cfg.d_model) + rs.randn(cfg.d_model)) \
        .astype(np.float32)
    np.savez(d / "layer.npz", x=x, **{"p" + k: np.asarray(v) for k, v in
                                      mr.flat(p).items()})
    mr.run_sides(d, LAYER + TRAIN, LAYER + TRAIN + [ONE])
    return d


@pytest.mark.parametrize("case", LAYER)
def test_ep_layer_matches_reference_shard_map(runs, case):
    got, want = mr.result(runs, "port", case), mr.result(runs, "ref", case)
    assert (got["drops"] == want["drops"]).all()
    assert (got["drops"] > 0).all()                 # capacity bit
    scale = np.abs(want["out"]).max()
    assert np.abs(got["out"] - want["out"]).max() <= MOE_TOL * scale
    assert abs(float(got["aux"]) - float(want["aux"])) <= MOE_TOL
    mr.assert_ranks_agree(got)          # data shard 0's aux on every rank


@pytest.mark.parametrize("case", TRAIN)
def test_sharded_moe_steps_match_reference_mesh(runs, case):
    got, want = mr.result(runs, "port", case), mr.result(runs, "ref", case)
    assert len(got["moe_aux"]) == 2
    mr.assert_close_metrics(got, want)
    mr.assert_ranks_agree(got)
    mr.assert_close_params(got, want)


def test_data_sharded_aux_is_not_the_one_device_value(runs):
    """At 2 x 2 the step-1 loss and aux are data shard 0's, far outside
    the tolerance of the one-process step's; at 1 x 4 (one data shard)
    they equal it."""
    one = mr.result(runs, "port", ONE)
    two = mr.result(runs, "port", TRAIN[0])
    four = mr.result(runs, "port", TRAIN[1])
    assert abs(two["moe_aux"][0] - one["moe_aux"][0]) > 1e3 * MOE_TOL
    assert abs(two["loss"][0] - one["loss"][0]) > 1e2 * mr.REL_TOL
    mr.assert_close_metrics(four, one)
