"""``TorchRLHarness`` (``rl/harness.py``) and its task and reward modules
against the reference's ``RealRLHarness``, on the CPU (tiny-math, f32).

Across the packages, from the reference's initial weights:

  * one greedy step: the same responses (ids and tokens), the same
    rewards, the same registry snapshot (the reference's ``engine.jit``
    view aside: the port has no JIT cache), and params within 1e-5 of
    max |param| after the publish.  Greedy siblings of a GRPO group are
    identical, so every advantage, and the publish's step, is zero in
    both packages;
  * so the trainer half is also held on the reference's own sampled
    rollout, with rewards that differ inside a group: the port's
    ``train_fn`` / ``publish_fn`` fed the reference's microbatches give
    params within 1e-5 of max |param| in 99.9% of elements and within a
    tenth of lr in all: where a gradient is near Adam's eps (the k bias's
    is rounding noise), g / (|g| + eps) amplifies f32 summation order, as
    in ``tests/test_torch_train.py``.

Within the port, at temperature 1 (sampled tokens are not held equal to
the reference's, ROADMAP "Deliberate differences"), the reference's
run-level properties: streamed and batch collection give byte-equal
params and optimizer state; a run crashed inside step 3 and resumed from
its checkpoint gives the uninterrupted run's responses and byte-equal
params and optimizer state; a response straddling a mid-stream weight
swap is masked out of the loss.  The seeds give rewards that differ
inside a group, so the gradients are not zero; each test asserts it.

Last, the card's phase 9 helpers at tiny width: ``chip_smoke.rl_seed_scan``
predicts the rewards ``chip_smoke.rl_harness`` runs get, the reclaim at
``RL_REMOVE_AT`` finds live requests whose KV another engine pulls, and
``chip_smoke.rl_dry_run`` sees them there.
"""

import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import perfmodel as jpm
from repro.core.hybrid_runtime import RunnerConfig as JaxRunnerConfig
from repro.core.spot_trace import TraceEvent as JaxTraceEvent
from repro.data import tasks as jtasks
from repro.models import init_params as jax_init_params
from repro.rl import rewards as jrewards
from repro.rl.harness import RealRLHarness
from repro.rl.harness import tiny_math_config as jax_tiny_math
from repro_torch.core import perfmodel as pm
from repro_torch.core.faults import FaultPlan, TrainerCrash, check_invariants
from repro_torch.core.hybrid_runtime import RunnerConfig
from repro_torch.core.microbatch import StreamedCollection
from repro_torch.core.requests import Request
from repro_torch.core.spot_trace import TraceEvent
from repro_torch.data import tasks
from repro_torch.data import tokenizer as tok
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import init_params
from repro_torch.optim import adamw
from repro_torch.rl import harness as harness_mod
from repro_torch.rl import rewards
from repro_torch.rl.harness import TorchRLHarness, tiny_math_config
from repro_torch.rl.sampler import request_key
from repro_torch.serving.engine import InferenceEngine
from repro_torch.transfer.chunkstore import tree_items

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

PARAM_REL_TOL = 1e-5        # of max |param|
EPS_LR_SHARE = 0.1          # of lr, where a gradient is near Adam's eps


def _np_leaves(tree):
    return {k: v.detach().float().numpy() for k, v in tree_items(tree)}


def _ref_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _equal_trees(a, b):
    la, lb = list(tree_items(a)), list(tree_items(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


def _ref_figures(monkeypatch):
    """The reference's event clock in the port: its device figures and the
    reference harness's pacing model (n_params 8.2e11, DCN scale 52)."""
    monkeypatch.setattr(pm, "PEAK_FLOPS", jpm.PEAK_FLOPS)
    monkeypatch.setattr(pm, "HBM_BW", jpm.HBM_BW)
    monkeypatch.setattr(harness_mod, "PACING_N_PARAMS", 8.2e11)
    monkeypatch.setattr(harness_mod, "PACING_GBPS_SCALE", 52.0)


def _ref_params(seed=0):
    jparams = jax_init_params(jax_tiny_math(), jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      tiny_math_config(), "cpu")


# --------------------------------------------------------------------------- #
# data/tasks.py and rl/rewards.py: copies, equal on every input
# --------------------------------------------------------------------------- #
def test_tasks_and_rewards_equal_reference():
    for seed, digits in ((0, 1), (3, 2), (12345, 3)):
        ds = tasks.MathTaskDataset(seed=seed, digits=digits)
        jds = jtasks.MathTaskDataset(seed=seed, digits=digits)
        for s, js in zip(ds.batch(7, 40), jds.batch(7, 40)):
            assert (s.index, s.prompt, s.answer, s.prompt_ids) == \
                (js.index, js.prompt, js.answer, js.prompt_ids)
    rs = np.random.RandomState(0)
    ds = tasks.MathTaskDataset(seed=0, digits=1)
    for i in range(300):
        ans = ds.sample(i).answer
        ids = rs.randint(0, tok.VOCAB_SIZE, size=rs.randint(0, 8)).tolist()
        if i % 3 == 0:                  # some right answers, some prefixes
            ids = tok.encode(ans, bos=False)[:1 + i % 2] + ids[:i % 4]
        if i % 5 == 0:
            ids = ids + [tok.EOS] + ids
        assert rewards.partial_credit(ids, ans) == \
            jrewards.partial_credit(ids, ans)
        assert rewards.verify_math(ids, ans) == jrewards.verify_math(ids, ans)
    assert rewards.batch_rewards([[tok.encode("7", bos=False)[0]]], ["7"]) \
        == [1.0]


def test_harness_defaults_to_cuda():
    rc = RunnerConfig(mode="rlboost", n_prompts=1, group_size=2, m_b=2)
    if torch.cuda.is_available():
        assert TorchRLHarness(tiny_math_config(), rc).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchRLHarness(tiny_math_config(), rc)


def test_pacing_targets_on_h100_figures():
    """The harness's pacing model on the port's own figures: ~1 s a decode
    round of 8 rows on a spot instance, 5 s a weight pull's bytes over its
    NIC, 2 s a snapshot."""
    h = TorchRLHarness(tiny_math_config(), RunnerConfig(
        mode="rlboost", n_prompts=1, group_size=2, m_b=2), device="cpu")
    perf, rc = h.runner.perf, h.rc
    spot = h.runner.manager.spot_kind
    assert perf.decode_step_time(spot, 8, 32.0, tiny_math_config()) == \
        pytest.approx(1.0, rel=1e-3)
    assert perf.weight_bytes / (spot.dcn_gbps * 1e9 / 8) == \
        pytest.approx(5.0, rel=1e-6)
    assert perf.weight_bytes / rc.snapshot_d2h_bw == 2.0


# --------------------------------------------------------------------------- #
# across the packages
# --------------------------------------------------------------------------- #
KW = dict(mode="rlboost", n_prompts=2, group_size=2, m_b=2, seed=0,
          t_seed_init=5.0)


def test_greedy_step_equals_reference(monkeypatch):
    _ref_figures(monkeypatch)
    jh = RealRLHarness(jax_tiny_math(), JaxRunnerConfig(**KW), max_new=6,
                       temperature=0.0)
    jh.runner.load_trace([JaxTraceEvent(0.0, +2)])
    jm, jrw = jh.run(1)
    jparams, params = _ref_params(0)
    h = TorchRLHarness(tiny_math_config(), RunnerConfig(**KW), max_new=6,
                       temperature=0.0, params=params, device="cpu")
    h.runner.load_trace([TraceEvent(0.0, +2)])
    m, rw = h.run(1)
    got = h.runner.journal.completed
    want = jh.runner.journal.completed
    assert sorted(got) == sorted(want) and len(got) == 4
    for rid in want:
        assert got[rid]["tokens"] == want[rid]["tokens"]
        assert got[rid]["group"] == want[rid]["group"]
    assert h.runner.journal.response_set() == jh.runner.journal.response_set()
    assert rw == jrw
    jsnap = {k: v for k, v in jm[0].items()
             if not k.startswith("engine.jit.")}
    assert m[0] == jsnap
    assert len(jm[0]) > len(jsnap)              # the dropped view
    # the publish: greedy group siblings are identical, so every advantage
    # and the AdamW step are zero in both packages
    got_p, want_p = _np_leaves(h.params), _ref_leaves(jh.params)
    scale = max(float(np.abs(v).max()) for v in want_p.values())
    for k, v in want_p.items():
        assert np.abs(got_p[k] - v).max() <= PARAM_REL_TOL * scale, k
    assert int(h.opt["count"]) == int(jh.opt["count"]) == 1


def _as_port_request(r):
    out = Request(id=r.id, group=r.group, prompt_len=r.prompt_len,
                  max_total=r.max_total, prompt_ids=list(r.prompt_ids),
                  seed=r.seed)
    out.tokens, out.logprobs = list(r.tokens), list(r.logprobs)
    out.version_spans = [list(s) for s in r.version_spans]
    out.n_generated = r.n_generated
    return out


def test_trainer_on_the_reference_rollout(monkeypatch):
    """The reference harness's sampled step, microbatch by microbatch, into
    the port's trainer from the same weights: params and optimizer state
    within 1e-5 of max |param| after the publish, and the step not zero."""
    _ref_figures(monkeypatch)
    kw = dict(KW, n_prompts=4, group_size=4, m_b=4, seed=0)
    jh = RealRLHarness(jax_tiny_math(), JaxRunnerConfig(**kw), max_new=6)
    mbs = []
    inner = jh.runner.train_fn
    jh.runner.train_fn = lambda reqs: (mbs.append(
        [_as_port_request(r) for r in reqs]), inner(reqs))
    jh.runner.load_trace([JaxTraceEvent(0.0, +2)])
    _, jrw = jh.run(1)
    jparams, params = _ref_params(kw["seed"])    # the harness's init
    h = TorchRLHarness(tiny_math_config(), RunnerConfig(**kw), max_new=6,
                       params=params, device="cpu")
    h.runner.store.version = jh.runner.store.version - 1
    for mb in mbs:
        h._train_fn(mb)
    h._publish_fn()
    assert h.step_rewards == pytest.approx(jrw, abs=1e-7)
    by_group = {}
    for r in (r for mb in mbs for r in mb):
        by_group.setdefault(r.group, set()).add(rewards.partial_credit(
            r.tokens, h.dataset.sample(r.group).answer))
    assert any(len(v) > 1 for v in by_group.values()), \
        "premise: rewards differ inside a group"
    got_p, want_p = _np_leaves(h.params), _ref_leaves(jh.params)
    start = _ref_leaves(jparams)
    scale = max(float(np.abs(v).max()) for v in want_p.values())
    assert any(np.abs(want_p[k] - start[k]).max() > 0 for k in start)
    # Adam's step g / (|g| + eps) is ill-conditioned where |g| is near
    # eps = 1e-8 (the k bias's gradient is pure rounding noise: softmax is
    # blind to a shift shared by every key of a query); there the two
    # packages' f32 sums in another order move the step by a few percent
    # of lr.  Everywhere else the params agree within PARAM_REL_TOL.
    d = np.concatenate([np.abs(got_p[k] - v).ravel()
                        for k, v in want_p.items()])
    assert d.max() <= EPS_LR_SHARE * h.lr
    assert (d > PARAM_REL_TOL * scale).mean() <= 1e-3
    for key in ("m", "v", "master"):
        got_s = _np_leaves(h.opt[key])
        want_s = _ref_leaves(jh.opt[key])
        for k, v in want_s.items():
            tol = (EPS_LR_SHARE * h.lr if key == "master" else
                   PARAM_REL_TOL * max(float(np.abs(v).max()), scale))
            assert np.abs(got_s[k] - v).max() <= tol, (key, k)


# --------------------------------------------------------------------------- #
# within the port, at temperature 1
# --------------------------------------------------------------------------- #
TRACE = [TraceEvent(0.0, +2)]


def _moved(h, params0):
    return not _equal_trees(h.params, params0)


def test_streamed_vs_batch_final_params_bit_identical():
    """One tail flush a step (m_b = n_prompts x G), so the accumulation
    partition is the same by construction: streamed and batch collection
    give byte-equal params and optimizer state, with the same responses,
    staleness and rewards, and streamed banks overlap.  The reference's
    copy also asserts that streamed ends the run earlier on the event
    clock; it does not (ROADMAP "Reference faults": the 1 s step-start
    poll swallows step 1's credit, and the seeding controller then keeps
    t_seed longer), so this copy leaves that claim out."""
    runs = {}
    params0 = init_params(tiny_math_config(),
                          torch.Generator().manual_seed(2), "cpu")
    for collection in ("batch", "streamed"):
        rc = RunnerConfig(mode="rlboost", n_prompts=2, group_size=4, m_b=8,
                          seed=2, t_seed_init=5.0, collection=collection)
        h = TorchRLHarness(tiny_math_config(), rc, max_new=6,
                           device="cpu")
        assert _equal_trees(h.params, params0)
        h.runner.load_trace(TRACE)
        metrics, rws = h.run(3)
        runs[collection] = (h, metrics, rws)
    hb, mb_, rwb = runs["batch"]
    hs, ms_, rws = runs["streamed"]
    assert _moved(hb, params0) and any(rwb)
    assert hs.runner.journal.response_set() == hb.runner.journal.response_set()
    assert [s["n"] for s in hs.staleness] == [s["n"] for s in hb.staleness]
    assert rws == rwb
    assert _equal_trees(hs.params, hb.params)
    assert _equal_trees(hs.opt, hb.opt)
    assert ms_[-1]["rollout.overlap_s"] > 0.0
    assert hs.runner.collector.n_rows_preprocessed == 8 * 3
    assert not hs._reward_cache


def test_real_backend_crash_resume_bit_identical(tmp_path):
    """The checkpoint's trainer payload (params, optimizer, the pending
    grad accumulator) restores through the harness: a run crashed inside
    step 3 and resumed gives the uninterrupted run's responses and
    byte-equal params and optimizer state."""
    def mkrc(ckpt_dir=None, crash_at=()):
        fp = FaultPlan(seed=0, trainer_crash_at=tuple(crash_at))
        return RunnerConfig(mode="rlboost", n_prompts=2, group_size=4,
                            m_b=4, seed=2, t_seed_init=5.0,
                            fault_plan=fp, ckpt_dir=ckpt_dir)

    cfg = tiny_math_config()
    params0 = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    h0 = TorchRLHarness(cfg, mkrc(), max_new=6, device="cpu")
    h0.runner.load_trace(TRACE)
    m0, rw0 = h0.run(3)
    ref = h0.runner.journal.response_set()
    assert ref and _moved(h0, params0) and rw0[-1] > 0

    d = str(tmp_path)
    crash_t = m0[1]["step.t_end"] + 3.0          # inside step 3
    h1 = TorchRLHarness(cfg, mkrc(d, (crash_t,)), max_new=6, device="cpu")
    h1.runner.load_trace(TRACE)
    with pytest.raises(TrainerCrash):
        h1.run(3)
    assert h1.runner.step_idx == 2

    h2 = TorchRLHarness(cfg, mkrc(d, (crash_t,)), max_new=6, device="cpu",
                        resume=True)
    assert h2.runner.step_idx == 2
    assert h2.runner.registry.counters["recovery.n_resumes"] == 1
    h2.runner.load_trace(TRACE)
    _, rw2 = h2.run(3)
    assert h2.runner.journal.response_set() == ref
    assert rw2 == rw0
    check_invariants(h2.runner.manager, [], journal=h2.runner.journal)
    assert _equal_trees(h2.params, h0.params)
    assert _equal_trees(h2.opt, h0.opt)


def test_real_staleness_masking_after_midstream_swap():
    cfg = tiny_math_config()
    params1 = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params2 = adamw.tree_map(lambda x: x * 1.01, params1)
    eng = InferenceEngine(cfg, params1, max_batch=4, slab_len=64,
                          temperature=1.0, weight_version=1, device="cpu")
    prompt = tok.encode("12+34=")
    reqs = {rid: Request(id=rid, group=0, prompt_len=len(prompt),
                         max_total=len(prompt) + 8, prompt_ids=prompt,
                         seed=0)
            for rid in (0, 1)}
    for rid, r in reqs.items():
        eng.add_request(rid, prompt, request_key(0, rid), r.max_total,
                        r.prompt_len)

    policy = StreamedCollection(group_size=2, min_microbatch=2)
    done = set()
    swapped_live = False
    for step in range(40):
        if step == 3:        # v2 lands mid-generation: swap, don't drop
            swapped_live = set(eng.active_request_ids()) == set(reqs)
            eng.swap_weights(params2, 2)
        for ev in eng.step():
            r = reqs[ev.req_id]
            r.tokens.append(ev.token)
            r.logprobs.append(ev.logprob)
            r.stamp_version(ev.weight_version)
            r.n_generated += 1
            policy.on_token(r)
            if ev.finished:
                r.completed_at = float(step)
                policy.add(r)
                done.add(ev.req_id)
        if done == set(reqs):
            break
    assert swapped_live, "premise: both requests live at the swap"
    assert done == {0, 1}
    assert policy.n_straddlers == 2              # both straddled the swap
    mb = policy.pop_microbatch()
    assert mb is not None and len(mb) == 2

    h = TorchRLHarness(cfg, RunnerConfig(mode="rlboost", n_prompts=2,
                                         group_size=2, m_b=4, seed=0),
                       max_new=6, staleness_limit=0, device="cpu")
    h.runner.store.version = 2                   # current published version
    batch = h._batch_from_requests(mb)
    assert h.n_stale_filtered == 2
    assert h.staleness[-1]["max"] == 1           # straddlers are 1 stale
    assert not batch["response_mask"].any()
    assert not batch["advantages"].any()


# --------------------------------------------------------------------------- #
# the card's phase 9 tools, at tiny width
# --------------------------------------------------------------------------- #
def test_smoke_seed_scan_predicts_the_harness(monkeypatch):
    """``chip_smoke.rl_seed_scan`` (one engine on the harness's initial
    weights) gives the rewards phase 9's harness run gets, step by step,
    wherever the earlier steps scored nothing (the weights are still the
    initial ones); tiny-math on the CPU, phase 9's runner and trace."""
    from repro_torch.core.spot_trace import TraceEvent as Ev
    cfg = tiny_math_config()
    seeds = (11, 23, 29)
    scan = chip_smoke.rl_seed_scan(torch, cfg, seeds, device="cpu")
    for seed in seeds:
        monkeypatch.setitem(chip_smoke.RL_RUNNER, "seed", seed)
        h, rec, _ = chip_smoke.rl_harness(
            time.perf_counter, cfg,
            [Ev(0.0, 2), Ev(chip_smoke.RL_REMOVE_AT, -1)], device="cpu")
        _, rws = h.run(chip_smoke.RL_STEPS)
        want = [sum(x) / len(x) for x in scan[seed]]
        assert want[:2] == [0.0, 0.0] and want[2] > 0, (seed, want)
        assert rws == want
        assert len(rec.steps) == chip_smoke.RL_STEPS
        assert rec.preempts and rec.preempts[0]["live"] > 0
        assert any(k["src"] == rec.preempts[0]["nic"] for k in rec.kv)
    # the dry run (no reclaim) sees the instance the reclaim picks, the
    # oldest spot instance, serving at RL_REMOVE_AT
    probes, _ = chip_smoke.rl_dry_run(time.perf_counter, cfg, device="cpu",
                                      until=chip_smoke.RL_REMOVE_AT + 1)
    live = dict(probes)[chip_smoke.RL_REMOVE_AT]
    assert live[min(live)] == rec.preempts[0]["live"] > 0
