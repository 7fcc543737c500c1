"""The port's sharding recipes, cost counting and dry run against the
reference's, on the CPU.

Spec trees (``param_specs`` under each recipe, ``opt_specs``,
``cache_specs``, ``train_batch_specs``) for every assigned arch, leaf for
leaf with the reference's under the reference test's ``FakeMesh``, equal
exactly, and its ``sanitize_spec`` cases; each cell's per-device argument
bytes equal to the shard bytes of the reference's sanitized specs; the
cost counter on a fake 16 x 16 mesh (a sharded matmul in a loop: the local
FLOPs and the collectives known in closed form, the counterpart of
``test_hlo_analysis_loop_multiplier``); one dry-run cell end to end; the
train CLI's mesh flags (a 2 x 1 mesh trains).  A fake process group is process-wide, so
everything that joins one runs in a subprocess.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import cell_status as jax_cell_status
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jshd
from repro.launch import specs as jax_specs
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, specs
from repro_torch.launch import train as train_cli

ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


class FakePods:
    shape = {"pod": 2, "data": 16, "model": 16}
    axis_names = ("pod", "data", "model")


def _flat(tree, path=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{path}['{k}']"))
        else:
            out[f"{path}['{k}']"] = v
    return out


def _jflat(tree, is_leaf=None):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _jspecs(tree):
    return {k: tuple(v) for k, v in
            _jflat(tree, lambda x: isinstance(x, JP)).items()}


def _specs(tree):
    return {k: tuple(v) for k, v in _flat(tree).items()}


def test_sanitize_spec_cases_match_reference():
    """The reference test's cases (test_sharding_and_dryrun.py:27-38),
    and the same specs through the reference, equal exactly."""
    m = FakeMesh()
    cases = [(("model", None), (50280, 768), m),
             (("model", None), (262144, 768), m),
             (("data", "model", None), (3584, 28, 128), m),
             ((("pod", "data"),), (16,), FakePods()),
             ((("pod", "data"), None), (3, 4), FakePods()),
             ((("data", "model"), None), (32, 4), m)]
    for spec, shape, mesh in cases:
        got = shd.sanitize_spec(shd.P(*spec), shape, mesh)
        assert tuple(got) == tuple(jshd.sanitize_spec(JP(*spec), shape,
                                                      mesh))
    assert shd.sanitize_spec(shd.P("model", None), (50280, 768), m) == \
        shd.P(None, None)
    assert shd.sanitize_spec(shd.P(("pod", "data"),), (16,),
                             FakePods()) == shd.P("pod")


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    m = FakeMesh()
    assert shd.to_placements(shd.P("data", "model", None), m) == \
        (Shard(0), Shard(1))
    assert shd.to_placements(shd.P(None, ("data", "model")), m) == \
        (Shard(1), Shard(1))
    assert shd.to_placements(shd.P(), m) == (Replicate(), Replicate())
    assert shd.to_placements(shd.P(("pod", "data"), None, "model"),
                             FakePods()) == (Shard(0), Shard(0), Shard(2))
    assert shd.local_shape(shd.P(("data", "model"), None), (512, 3), m) == \
        (2, 3)


def _jax_cell_specs(jcfg, name, state, recipe, mesh):
    """The reference dry run's (build_cell) argument trees and specs."""
    shape = JAX_SHAPES[name]
    b = jshd.batch_axes(mesh, recipe)
    if shape.kind == "train":
        batch = jax_specs.train_batch_spec(jcfg, shape)
        ps = jshd.param_specs(jcfg, state["params"], recipe, mesh=mesh)
        return ((state, batch),
                ({"params": ps, "opt": jshd.opt_specs(jcfg, state["opt"],
                                                      ps)},
                 jshd.train_batch_specs(mesh, recipe, batch)))
    ps = jshd.param_specs(jcfg, state["params"], recipe, mesh=mesh)
    if shape.kind == "prefill":
        batch = jax_specs.prefill_batch_spec(jcfg, shape)
        return ((state["params"], batch),
                (ps, jshd.train_batch_specs(mesh, recipe, batch)))
    cache = jax_specs.decode_cache_spec(jcfg, shape)
    tok = jax.ShapeDtypeStruct((shape.global_batch,), np.int32)
    return ((state["params"], cache, tok),
            (ps, jshd.cache_specs(jcfg, cache, mesh, recipe),
             jshd.sanitize_spec(JP(b), (shape.global_batch,), mesh)))


def _jax_shard_bytes(trees, spec_trees, mesh):
    total = 0
    for t, s in zip(trees, spec_trees):
        leaves = _jflat(t) if isinstance(t, dict) else {"": t}
        specs_ = _jspecs(s) if isinstance(s, dict) else {"": tuple(s)}
        for k, leaf in leaves.items():
            spec = specs_[k] + (None,) * (len(leaf.shape) - len(specs_[k]))
            n = 1
            for d, axes in zip(leaf.shape, spec):
                div = 1
                for a in ((axes,) if isinstance(axes, str) else axes or ()):
                    div *= mesh.shape[a]
                n *= d // div
            total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", JAX_ASSIGNED)
def test_spec_trees_and_arg_bytes_equal_the_reference(arch):
    """Every recipe's param and optimizer specs, the decode caches' specs
    (decode_32k, and long_500k where it runs) and the batches' specs,
    leaf for leaf and exactly; then each runnable cell's per-device
    argument bytes under fsdp_tp on pod1 against the shard bytes of the
    reference's sanitized specs, exactly."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    m = FakeMesh()
    jstate = jax_specs.abstract_state(jcfg)
    state = specs.abstract_state(cfg)
    for recipe in shd.RECIPES:
        jps = jshd.param_specs(jcfg, jstate["params"], recipe, mesh=m)
        ps = shd.param_specs(cfg, state["params"], recipe, mesh=m)
        assert _specs(ps) == _jspecs(jps), recipe
        assert _specs(shd.opt_specs(cfg, state["opt"], ps)) == _jspecs(
            jshd.opt_specs(jcfg, jstate["opt"], jps))
        for name in ("decode_32k", "long_500k"):
            if not jax_cell_status(jcfg, JAX_SHAPES[name])[0]:
                continue
            jc = jax_specs.decode_cache_spec(jcfg, JAX_SHAPES[name])
            c = specs.decode_cache_spec(cfg, SHAPES[name])
            assert _specs(shd.cache_specs(cfg, c, m, recipe)) == _jspecs(
                jshd.cache_specs(jcfg, jc, m, recipe)), (recipe, name)
        jb = jax_specs.train_batch_spec(jcfg, JAX_SHAPES["train_4k"])
        b = specs.train_batch_spec(cfg, SHAPES["train_4k"])
        assert _specs(shd.train_batch_specs(m, recipe, b)) == _jspecs(
            jshd.train_batch_specs(m, recipe, jb))
    for name in SHAPES:
        if not jax_cell_status(jcfg, JAX_SHAPES[name])[0]:
            continue
        trees, spec_trees = dryrun.cell_inputs(cfg, SHAPES[name], m,
                                               "fsdp_tp")
        got = sum(dryrun.shard_bytes(t, s, m)
                  for t, s in zip(trees, spec_trees))
        jt, js = _jax_cell_specs(jcfg, name, jstate, "fsdp_tp", m)
        assert got == _jax_shard_bytes(jt, js, m), name


def _subprocess(code: str, timeout: int):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=timeout)


def test_cost_counts_local_work_on_a_fake_mesh():
    """A 16 x 16 fake mesh (``launch.mesh.make_production_mesh``): x [256,
    4096] f32 with its contraction dim sharded over "model" and its rows
    over "data", times w [4096, 4096] with its rows sharded over "model":
    each device multiplies [16, 256] by [256, 4096], and the partial sums
    are all-reduced over "model" (64 KiB a device), ten times in a loop.
    The counted FLOPs are the local ones only (DTensor's global-shape
    propagation hidden), the collectives one all-reduce an iteration,
    and CommDebugMode's count agrees (``analyze`` checks it)."""
    out = _subprocess("""
        import json, torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.launch import cost_analysis as ca
        from repro_torch.launch.dryrun import init_fake_world
        from repro_torch.launch.mesh import make_production_mesh
        init_fake_world(256)
        mesh = make_production_mesh(device_type="cpu")
        def step(x, w):
            for _ in range(10):
                y = (x @ w).redistribute(mesh, [Shard(0), Replicate()])
                x = torch.tanh(y).redistribute(mesh, [Shard(0), Shard(1)])
            return x
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(16, 256), mesh,
                                   [Shard(0), Shard(1)], run_check=False,
                                   shape=(256, 4096), stride=(4096, 1))
            w = DTensor.from_local(torch.empty(256, 4096), mesh,
                                   [Replicate(), Shard(0)],
                                   run_check=False, shape=(4096, 4096),
                                   stride=(4096, 1))
            c = ca.analyze(step, x, w)
        print(json.dumps(dict(names=mesh.mesh_dim_names,
                              shape=list(mesh.shape), flops=c.dot_flops,
                              coll=c.collectives,
                              counts=c.collective_counts,
                              peak=c.peak_bytes)))
    """, 240)
    assert out.returncode == 0, out.stdout + out.stderr
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["names"] == ["data", "model"] and r["shape"] == [16, 16]
    assert r["flops"] == 10 * 2 * 16 * 256 * 4096
    assert r["counts"] == {"all-reduce": 10}
    assert r["coll"] == {"all-reduce": 10 * 16 * 4096 * 4}
    assert r["peak"] > 0


def test_dryrun_cell_subprocess(tmp_path):
    """One cell end to end through the CLI, as the reference's test runs
    it: mamba2-130m x long_500k on pod1 (256 fake ranks) and on pod2
    (512): ok, the chip count, a bottleneck, the reference's useful-work
    FLOPs; and a skipped cell recorded with the reference's reason."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for extra, chips, mesh in (([], 256, "pod1"),
                               (["--multi-pod"], 512, "pod2")):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "mamba2-130m", "--shape", "long_500k", "--outdir",
             str(tmp_path)] + extra, capture_output=True, text=True,
            env=env, cwd=ROOT, timeout=300)
        assert "[OK]" in out.stdout, out.stdout + out.stderr
        rec = json.loads((tmp_path / f"mamba2-130m__long_500k__{mesh}"
                          f"__fsdp_tp.json").read_text())
        assert rec["ok"] and rec["chips"] == chips
        assert rec["roofline"]["bottleneck"] in ("compute_s", "memory_s",
                                                 "collective_s")
        assert rec["per_device"]["dot_flops"] > 0
        assert rec["model_flops"] == 2.0 * get_config(
            "mamba2-130m").active_param_count()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-7b", "--shape", "long_500k", "--outdir", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    rec = json.loads((tmp_path / "qwen2-7b__long_500k__pod1__fsdp_tp.json")
                     .read_text())
    assert rec["skipped"] and rec["ok"]
    assert rec["skip_reason"] == jax_cell_status(
        jax_get_config("qwen2-7b"), JAX_SHAPES["long_500k"])[1]


def test_train_cli_takes_the_mesh_flags(capsys):
    """``--data 1 --model 1 --recipe fsdp_tp`` trains as without them
    (the reference's one-device branch); ``--data 2`` trains on two ranks
    that the command spawns (gloo on the CPU), in its own process."""
    train_cli.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu",
                    "--steps", "1", "--data", "1", "--model", "1",
                    "--recipe", "fsdp_tp"])
    assert capsys.readouterr().out.rstrip().endswith("done")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-8b", "--reduced", "--device", "cpu", "--data", "2",
         "--steps", "1"], capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("step    0 loss=") and lines[-1] == "done"
