"""The port's examples (``examples/torch_*.py``) against the reference's
(``examples/*.py``), on the CPU.

  * Every example raises without a card when no ``--device`` is given.
  * The event-clock examples (``crash_resume``, ``streaming_collect``,
    ``flight_recorder``), with the port's perf-model figures set to the
    reference's: the same printed lines, the same runs (response sets and
    every step's registry snapshot) and, for the flight recorder, the same
    exported trace events.
  * ``quickstart`` at ``--reduced`` on the reference example's weights
    (its ``init_params`` carried over by ``params_from_numpy``) and train
    batch: the same greedy tokens, the train step's metrics within
    ``TRAIN_REL_TOL`` (f32 sums in another order), the same hybrid steps.
  * ``serve_rollout`` at ``--reduced`` on the reference's weights: the
    same v2 manifest (chunk digests), engine 1's installed v2 leaves
    within ``LEAF_REL_TOL`` of max |leaf| of the reference's
    ``installed``, and the per-token version spans' invariants.  Sampled
    tokens are not compared: at temperature 1 the packages' draws may
    round apart (ROADMAP "Deliberate differences"), so how many tokens a
    request emits may differ too.
  * ``hybrid_rl_training`` at ``--reduced``: a restart resumes at the
    saved step with params and optimizer state bit-equal to those saved.

The reference examples run in this process (``runpy`` for the two that
run at import, ``main`` for the others).
"""

import contextlib
import importlib.util
import io
import json
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import perfmodel as jpm
from repro.transfer.chunkstore import flatten_params as jax_flatten
from repro_torch.core import perfmodel as pm
from repro_torch.models.convert import params_from_numpy
from repro_torch.transfer.chunkstore import flatten_params, tree_items

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "serve_rollout", "hybrid_rl_training",
            "crash_resume", "streaming_collect", "flight_recorder")
TRAIN_REL_TOL = 1e-4        # quickstart's train metrics, relative
LEAF_REL_TOL = 1e-6         # serve_rollout's installed leaves, of max |leaf|


def _load(name: str, ref: bool):
    path = ROOT / "examples" / (f"{name}.py" if ref else f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"{'ref' if ref else 'port'}_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def ref_figures(monkeypatch):
    monkeypatch.setattr(pm, "PEAK_FLOPS", jpm.PEAK_FLOPS)
    monkeypatch.setattr(pm, "HBM_BW", jpm.HBM_BW)


def _printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _ref_main(mod, monkeypatch, argv=()):
    """The reference example's ``main`` on ``argv``, with every
    ``HybridRunner`` it builds recorded.  Returns (runners, stdout)."""
    runners = []

    class Recorded(mod.HybridRunner):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runners.append(self)
    monkeypatch.setattr(mod, "HybridRunner", Recorded)
    monkeypatch.setattr(sys, "argv", [mod.__name__, *argv])
    _, text = _printed(mod.main)
    return runners, text


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_cuda(name):
    main = _load(name, ref=False).main
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        main([])


# --------------------------------------------------------------------------- #
# the event-clock examples
# --------------------------------------------------------------------------- #
def test_crash_resume_equals_reference(ref_figures, monkeypatch):
    runners, want = _ref_main(_load("crash_resume", ref=True), monkeypatch)
    out, got = _printed(_load("crash_resume", ref=False).main,
                        ["--device", "cpu"])
    assert got == want
    r0, _, r2 = runners
    assert out["responses"] == r0.journal.response_set()
    assert out["resumed_responses"] == r2.journal.response_set()
    assert out["metrics"] == r0.metrics[-1]
    assert out["resumed"] == r2.metrics[-1]


def test_streaming_collect_equals_reference(ref_figures, monkeypatch):
    runners, want = _ref_main(_load("streaming_collect", ref=True),
                              monkeypatch)
    out, got = _printed(_load("streaming_collect", ref=False).main,
                        ["--device", "cpu"])
    assert got == want
    rb, rs = runners
    assert out["batch"] == rb.journal.response_set()
    assert out["streamed"] == rs.journal.response_set()
    assert out["batch_metrics"] == rb.metrics
    assert out["streamed_metrics"] == rs.metrics


def test_flight_recorder_equals_reference(ref_figures, monkeypatch,
                                          tmp_path):
    mod = _load("flight_recorder", ref=True)
    monkeypatch.setattr(mod, "OUT", tmp_path / "ref.trace.json")
    runners, want = _ref_main(mod, monkeypatch)
    out, got = _printed(_load("flight_recorder", ref=False).main,
                        ["--device", "cpu", "--out",
                         str(tmp_path / "port.trace.json")])
    # the same lines, but for the path of the trace each wrote
    assert got.replace("port.trace.json", "ref.trace.json") == want
    assert out["metrics"] == runners[0].metrics
    events = [json.loads((tmp_path / f"{side}.trace.json").read_text())
              for side in ("ref", "port")]
    assert events[1] == events[0]
    assert len(events[0]["traceEvents"]) > 100


# --------------------------------------------------------------------------- #
# the device examples at --reduced
# --------------------------------------------------------------------------- #
def _run_ref_script(name):
    """A reference example that runs at import: its globals."""
    g, _ = _printed(runpy.run_path, str(ROOT / "examples" / f"{name}.py"),
                    run_name="__main__")
    return g


def test_quickstart_equals_reference(ref_figures):
    g = _run_ref_script("quickstart")
    mod = _load("quickstart", ref=False)
    cfg = mod.model_config(mod.argparse.Namespace(reduced=True))
    params = params_from_numpy(jax.tree.map(np.asarray, g["params"]), cfg,
                               "cpu")
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in g["batch"].items()}
    out = mod.main(["--reduced", "--device", "cpu"], params=params,
                   batch=batch)
    assert out["config"].name == g["cfg"].name
    assert out["tokens"] == g["toks"] and len(out["tokens"]) == 10
    want = {k: float(v) for k, v in g["metrics"].items()}
    assert out["metrics"].keys() == want.keys()
    for k, v in want.items():
        assert abs(out["metrics"][k] - v) <= TRAIN_REL_TOL * abs(v), k
    assert out["metrics"]["grad_norm"] > 0
    assert out["hybrid"] == g["m"]


def test_serve_rollout_installs_the_reference_leaves():
    g = _run_ref_script("serve_rollout")
    mod = _load("serve_rollout", ref=False)
    cfg = mod.model_config(mod.argparse.Namespace(reduced=True))
    params = params_from_numpy(jax.tree.map(np.asarray, g["params"]), cfg,
                               "cpu")
    out = mod.main(["--reduced", "--device", "cpu"], params=params)
    assert out["manifest"].digests() == g["manifest"].digests()
    want = {k: np.asarray(v, np.float32)
            for k, v in jax_flatten(g["installed"]).items()}
    got = {k: v.float().numpy() for k, v in
           flatten_params(out["installed"]).items()}
    assert got.keys() == want.keys()
    for k, w in want.items():
        tol = LEAF_REL_TOL * max(float(np.abs(w).max()), 1e-30)
        assert np.abs(got[k] - w).max() <= tol, k
    # the spans: every request finished on engine 1, each token stamped
    # v1 or v2 in that order, the stamps as many as the tokens, and every
    # token engine 1 emitted after the publish (round 5) stamped v2
    for r in out["requests"].values():
        assert r["done"] and r["engine"] == 1
        assert len(r["versions"]) == len(r["tokens"]) > 0
        assert set(r["versions"]) == {1, 2}
        assert r["versions"] == sorted(r["versions"])
    assert all(v == 2 for rnd, eng, _, _, v in out["events"]
               if eng == 1 and rnd >= 5)
    assert len(out["requests"]) == len(g["requests"])


def test_hybrid_rl_training_resumes_bit_equal(tmp_path):
    mod = _load("hybrid_rl_training", ref=False)
    argv = ["--reduced", "--device", "cpu", "--ckpt-every", "1",
            "--ckpt-dir", str(tmp_path)]
    first, _ = _printed(mod.main, argv + ["--steps", "2"])
    assert first["start"] == 0 and first["done"] == 2
    saved = {"params": first["harness"].params,
             "opt": first["harness"].opt}
    restored = []

    def on_restore(state):
        restored.append([(k, v.clone()) for k, v in tree_items(state)])
    second, text = _printed(mod.main, argv + ["--steps", "3"],
                            on_restore=on_restore)
    assert "[restart] resumed from checkpoint step 2" in text
    assert second["start"] == 2 and second["done"] == 3
    want = list(tree_items(saved))
    assert [k for k, _ in restored[0]] == [k for k, _ in want]
    for (k, a), (_, b) in zip(restored[0], want):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert sorted(p.name for p in tmp_path.glob("step_*.json")) == [
        "step_00000002.json", "step_00000003.json"]
