"""The sharded trainer's checkpoints and its command line, on the CPU.

* A checkpoint saved on a 2 x 2 mesh after step 1 (every rank gathers,
  rank 0 writes) resumes on one process (no mesh) and on a 4 x 1 mesh:
  step 2 equals the uninterrupted 2 x 2 run's (loss, ``grad_norm`` and
  every param after, within the tolerances ``tests/mesh_ranks.py``
  states), reduced ``qwen3-8b``, 4 gloo ranks in one spawn.
* ``python -m repro_torch.launch.train --device cpu --backend gloo --data
  2 --model 2`` spawns its 4 ranks, prints the step lines and ``done``
  once, checkpoints, and a 1 x 1 run resumes from its checkpoint;
  ``--model 2 --recipe pure_fsdp`` trains too (gloo by default on the
  CPU); ``--backend nccl`` on the CPU is refused; under ``torchrun`` the
  command joins the group torchrun made instead of spawning ranks.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import mesh_ranks as mr

ROOT = Path(__file__).resolve().parents[1]
SAVE = "save:qwen3-8b:2:2:fsdp_tp"
RESUME = ["resume:qwen3-8b:1:1:fsdp_tp", "resume:qwen3-8b:4:1:fsdp_tp"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_ckpt")
    mr.write_inputs(d, ["qwen3-8b"])
    mr.run_sides(d, [], [SAVE] + RESUME)
    return d


@pytest.mark.parametrize("case", RESUME)
def test_checkpoint_resumes_on_another_mesh(runs, case):
    got, want = mr.result(runs, "port", case), mr.result(runs, "port", SAVE)
    assert len(got["loss"]) == 1 and len(want["loss"]) == 2
    mr.assert_close_metrics(got, {k: want[k][1:] for k in
                                  ("loss", "grad_norm")})
    if "ranks_agree" in got:                  # the 4 x 1 resume
        mr.assert_ranks_agree(got)
    mr.assert_close_params(got, want)


def _train(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-8b", "--reduced", "--device", "cpu", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=timeout)


def test_cli_trains_on_four_ranks_and_resumes_on_one(tmp_path):
    out = _train("--backend", "gloo", "--data", "2", "--model", "2",
                 "--steps", "2", "--ckpt-dir", str(tmp_path),
                 "--ckpt-every", "1")
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert [ln.split()[:2] for ln in lines if ln.startswith("step")] == \
        [["step", "0"], ["step", "1"]]
    assert lines[-1] == "done" and lines.count("done") == 1
    assert all(re.search(r"loss=\d+\.\d+ grad_norm=\d+\.\d+", ln)
               for ln in lines if ln.startswith("step"))
    out = _train("--steps", "3", "--ckpt-dir", str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[restart] resumed from step 2" in out.stdout
    assert out.stdout.rstrip().endswith("done")


def test_cli_model_two_trains_and_nccl_on_the_cpu_is_refused():
    out = _train("--model", "2", "--recipe", "pure_fsdp", "--steps", "1")
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.rstrip().endswith("done")
    out = _train("--backend", "nccl", "--data", "2", "--model", "2")
    assert out.returncode == 2
    assert "--backend nccl needs --device cuda" in out.stderr


def test_cli_joins_the_group_under_torchrun():
    """Two ranks made by ``torchrun`` (``RANK`` / ``WORLD_SIZE`` in the
    environment): the command joins their group, rank 0 prints the step
    lines and ``done`` once, the same as the spawned 2 x 1 run's."""
    from repro_torch.launch.train import free_port
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    common = ["-m", "repro_torch.launch.train", "--arch", "qwen3-8b",
              "--reduced", "--device", "cpu", "--data", "2", "--steps", "2"]
    runs = [subprocess.run(
        [sys.executable, *pre, *common], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300) for pre in (
            ["-m", "torch.distributed.run", "--nproc_per_node", "2",
             "--master_port", str(free_port())], [])]
    for out in runs:
        assert out.returncode == 0, out.stdout + out.stderr
    steps = [[ln for ln in out.stdout.splitlines() if ln.startswith("step")]
             for out in runs]
    assert len(steps[0]) == 2 and runs[0].stdout.count("done") == 1
    # the same losses and norms (the seconds differ)
    assert [ln.split("(")[0] for ln in steps[0]] == \
        [ln.split("(")[0] for ln in steps[1]]
