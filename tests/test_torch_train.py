"""The port's GRPO trainer against the reference's, on the CPU, in f32.

Same weights (``repro.models.init_params`` carried across with
``params_from_numpy``) and the same batches (made with numpy from a seed)
go through both packages: the train-mode forward, ``token_logprobs`` in
one block and in 512-token blocks, ``grpo_loss`` with its gradients,
AdamW, three ``make_train_step`` steps, both advantage functions.  Then
the port's own loop: engine rollouts at temperature 1 scored by the
trainer on the same weights (the on-policy identity), and the train CLI
with a resume, the last one onto a 1 x 2 mesh of two ranks.  Each
tolerance is stated where it is used.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models.transformer import CPU_RT
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import token_logprobs as jax_token_logprobs
from repro.optim import adamw as jax_adamw
from repro.rl import grpo as jax_grpo
from repro.rl.harness import tiny_math_config as jax_tiny_math
from repro_torch.configs import get_config, tiny_math_config
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import forward, token_logprobs
from repro_torch.optim import adamw
from repro_torch.rl import grpo
from repro_torch.rl.sampler import request_key
from repro_torch.serving.engine import InferenceEngine

HIDDEN_TOL = 1e-4       # f32, sums in another order over 2 layers
_CASES = {
    "tiny-math": (jax_tiny_math, tiny_math_config),
    "qwen3-8b-reduced": (lambda: jax_get_config("qwen3-8b").reduced(),
                         lambda: get_config("qwen3-8b").reduced()),
}


def _models(name, seed=4):
    jcfg, cfg = (f() for f in _CASES[name])
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _tokens(vocab, B, S, seed=0):
    return np.random.RandomState(seed).randint(3, vocab, size=(B, S)) \
        .astype(np.int32)


def _to_np(tree):
    return {k: _to_np(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in tree.items()}


def _max_diff(a, b):
    fa, fb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(fa) == len(fb)
    return max(float(np.abs(np.asarray(x, np.float32)
                            - np.asarray(y, np.float32)).max())
               for x, y in zip(fa, fb))


def _batch(vocab, B=4, S=24, seed=1):
    rs = np.random.RandomState(seed)
    mask = np.zeros((B, S), np.float32)
    for i in range(B):
        mask[i, 5 + i:S - i] = 1.0                # ragged responses
    return {"tokens": _tokens(vocab, B, S, seed),
            "response_mask": mask,
            "advantages": rs.randn(B).astype(np.float32),
            # near the policy's own logprobs (~ -log V), so some ratios
            # fall outside the clip range and some inside
            "behavior_logprobs": (-np.log(vocab) + 0.3 * rs.randn(B, S))
            .astype(np.float32),
            "ref_logprobs": (-np.log(vocab) + 0.3 * rs.randn(B, S))
            .astype(np.float32)}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# --------------------------------------------------------------------------- #
# model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name,S,use_pallas", [("tiny-math", 40, False),
                                               ("tiny-math", 128, True),
                                               ("qwen3-8b-reduced", 77, False),
                                               ("qwen3-8b-reduced", 128,
                                                True)])
def test_train_forward_hidden_matches_reference(name, S, use_pallas):
    """Final hidden states of the full-sequence forward, within 1e-4 of the
    reference's jnp path, or of its Pallas flash kernel in interpret mode
    (which it takes only at S % 128 == 0)."""
    jcfg, jparams, cfg, params = _models(name)
    toks = _tokens(cfg.vocab_size, 2, S)
    rt = dataclasses.replace(CPU_RT, use_pallas=use_pallas)
    want = jax_forward(jparams, jcfg, rt, tokens=jnp.asarray(toks),
                       mode="train")["hidden"]
    got = forward(params, cfg, tokens=torch.from_numpy(toks),
                  mode="train")["hidden"]
    assert got.shape == (2, S, cfg.d_model)
    assert _max_diff(got.numpy(), want) <= HIDDEN_TOL


@pytest.mark.parametrize("S", [100, 700])
def test_token_logprobs_matches_reference(S):
    """One block (S <= 512) and 512-token blocks under checkpoint: within
    1e-4 (f32 log-softmax over the vocab)."""
    jcfg, jparams, cfg, params = _models("qwen3-8b-reduced")
    rs = np.random.RandomState(S)
    hidden = rs.randn(2, S, cfg.d_model).astype(np.float32)
    targets = rs.randint(0, cfg.vocab_size, (2, S)).astype(np.int32)
    want = jax_token_logprobs(jparams, jcfg, jnp.asarray(hidden),
                              jnp.asarray(targets))
    h = torch.from_numpy(hidden).requires_grad_(True)
    got = token_logprobs(params, cfg, h, torch.from_numpy(targets))
    assert _max_diff(got.detach().numpy(), want) <= 1e-4
    got.sum().backward()                    # the blocks' recompute runs
    assert torch.isfinite(h.grad).all()


def test_remat_gives_the_same_gradients():
    """Per-layer recompute (``remat=True``) changes memory, not values."""
    _, _, cfg, params = _models("qwen3-8b-reduced")
    batch = _tbatch(_batch(cfg.vocab_size))
    _, m0, g0 = grpo.loss_and_grads(params, cfg, batch)
    _, m1, g1 = grpo.loss_and_grads(params, cfg, batch, remat=True)
    assert float(m0["loss"]) == float(m1["loss"])
    assert _max_diff(_to_np(g0), _to_np(g1)) <= 1e-6


# --------------------------------------------------------------------------- #
# GRPO and AdamW
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kl_coef", [0.0, 0.1])
def test_grpo_loss_value_metrics_and_grads_match_reference(kl_coef):
    """Loss and metrics within 1e-5, gradients within 1e-5 + 1e-3 x the
    largest gradient of the leaf (f32)."""
    jcfg, jparams, cfg, params = _models("tiny-math")
    b = _batch(cfg.vocab_size)

    def jloss(p):
        return jax_grpo.grpo_loss(p, jcfg, CPU_RT, _jbatch(b), kl_coef=kl_coef)
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    loss, metrics, grads = grpo.loss_and_grads(params, cfg, _tbatch(b),
                                               kl_coef=kl_coef)
    assert set(metrics) == set(jm)
    assert abs(float(loss) - float(jl)) <= 1e-5
    for k in jm:
        assert abs(float(metrics[k]) - float(jm[k])) <= 1e-5, k
    for g, w in zip(jax.tree.leaves(_to_np(grads)), jax.tree.leaves(jg)):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-5 + 1e-3 * np.abs(w).max()


def _rand_tree(tree, seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (scale * rs.randn(*np.shape(a)))
                        .astype(np.float32), tree)


def test_adamw_apply_matches_reference():
    """One step from a state with nonzero moments: params, m, v, master
    within 1e-6, the count and the grad norm (clipped at 1) equal."""
    jcfg, jparams, cfg, params = _models("tiny-math")
    jnp_params = jax.tree.map(np.asarray, jparams)
    grads = _rand_tree(jnp_params, 1, 0.1)
    jopt = jax_adamw.init(jparams)
    jopt = dict(jopt, m=_rand_tree(jnp_params, 2, 0.01),
                v=jax.tree.map(np.abs, _rand_tree(jnp_params, 3, 1e-3)),
                count=jnp.asarray(4, jnp.int32))
    jnew, jst, jm = jax_adamw.apply(jax.tree.map(jnp.asarray, grads), jopt,
                                    jparams, lr=1e-3, weight_decay=0.01)
    conv = lambda t: params_from_numpy(t, cfg, "cpu")  # noqa: E731
    opt = adamw.init(params)
    opt.update(m=conv(jax.tree.map(np.asarray, jopt["m"])),
               v=conv(jax.tree.map(np.asarray, jopt["v"])))
    opt["count"].fill_(4)
    new, st, m = adamw.apply(conv(grads), opt, params, lr=1e-3,
                             weight_decay=0.01)
    assert st is opt and int(st["count"]) == 5 == int(jst["count"])
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5
    for key in ("m", "v", "master"):
        assert _max_diff(_to_np(st[key]), jst[key]) <= 1e-6, key
    assert _max_diff(_to_np(new), jnew) <= 1e-6
    # the new params never alias the master copy the next step updates
    assert all(a.data_ptr() != b.data_ptr() for a, b in
               zip(adamw.tree_leaves(new), adamw.tree_leaves(st["master"])))


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    """Clipped (max_norm 1) and untouched (100) grads within 1e-6, the norm
    within 1e-5 (f32)."""
    jcfg, jparams, cfg, params = _models("tiny-math")
    grads = _rand_tree(jax.tree.map(np.asarray, jparams), 6, 0.1)
    jclipped, jnorm = jax_adamw.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads), max_norm)
    clipped, norm = adamw.clip_by_global_norm(
        params_from_numpy(grads, cfg, "cpu"), max_norm)
    assert abs(float(norm) - float(jnorm)) <= 1e-5
    assert _max_diff(_to_np(clipped), jclipped) <= 1e-6


def test_warmup_cosine_matches_reference():
    for step in (0, 3, 10, 55, 100, 140):
        want = jax_adamw.warmup_cosine(jnp.asarray(step), base_lr=1e-3,
                                       warmup=10, total=100)
        got = adamw.warmup_cosine(step, base_lr=1e-3, warmup=10, total=100)
        assert abs(float(got) - float(want)) <= 1e-9


def test_make_train_step_three_steps_match_reference():
    """Three GRPO steps (lr 1e-3) from the same weights on three batches:
    losses within 1e-5; 99% of the param elements within 1e-6 of the
    reference's and every one within 1e-4.  Adam's step g / (|g| + eps) is
    ill-conditioned where |g| is near eps = 1e-8: the k bias gets a
    gradient of pure rounding noise (the softmax is blind to a shift that
    is the same for every key), and there f32 sums in another order move
    the step by a few percent of lr."""
    jcfg, jparams, cfg, params = _models("tiny-math")
    jstep = jax.jit(jax_grpo.make_train_step(jcfg, CPU_RT, lr=1e-3))
    step = grpo.make_train_step(cfg, lr=1e-3)
    jstate = jax_grpo.init_train_state(jparams)
    state = grpo.init_train_state(params, "cpu")
    for i in range(3):
        b = _batch(cfg.vocab_size, seed=10 + i)
        b.pop("ref_logprobs")
        jstate, jm = jstep(jstate, _jbatch(b))
        state, m = step(state, _tbatch(b))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
    assert int(state["opt"]["count"]) == 3
    diffs = np.concatenate([
        np.abs(a - np.asarray(w)).ravel() for a, w in
        zip(jax.tree.leaves(_to_np(state["params"])),
            jax.tree.leaves(jstate["params"]))])
    assert diffs.max() <= 1e-4 and (diffs > 1e-6).mean() <= 1e-2


def test_group_advantages_match_reference():
    rs = np.random.RandomState(0)
    r = rs.rand(12).astype(np.float32)
    want = np.asarray(jax_grpo.group_advantages(jnp.asarray(r), 4))
    got = grpo.group_advantages(torch.from_numpy(r), 4).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    groups = {7: [0, 5, 9], 3: [1, 2], 8: [3, 4, 6, 7, 8], 1: [10, 11]}
    np.testing.assert_array_equal(
        grpo.group_normalized_advantages(r, groups),
        jax_grpo.group_normalized_advantages(r, groups))


# --------------------------------------------------------------------------- #
# the port's own loop
# --------------------------------------------------------------------------- #
def test_on_policy_identity_on_engine_rollouts():
    """tiny-math in f32: the engine samples at temperature 1 and records
    each token's logprob; the trainer's logprobs of the same tokens under
    the same weights agree, so the first step's ratio_mean is 1 within
    1e-4 (f32 through two attention paths)."""
    cfg = tiny_math_config()
    params = params_from_numpy(jax.tree.map(np.asarray, jax_init_params(
        jax_tiny_math(), jax.random.PRNGKey(7))), cfg, "cpu")
    eng = InferenceEngine(cfg, params, max_batch=6, slab_len=64,
                          temperature=1.0, horizon=4, device="cpu")
    prompts = [[1] + list(range(3, 3 + n)) for n in (9, 14)]
    rid = 0
    for p in prompts:
        eng.add_group([(rid + j, request_key(0, rid + j), len(p) + 12)
                       for j in range(3)], p, len(p))
        rid += 3
    out = {r: [] for r in range(rid)}
    for _ in range(100):
        for e in eng.step():
            out[e.req_id].append((e.token, e.logprob))
        if not eng.n_active and not eng.waiting:
            break
    S = max(len(p) for p in prompts) + 12
    tokens = np.zeros((rid, S), np.int32)
    mask = np.zeros((rid, S), np.float32)
    beh = np.zeros((rid, S), np.float32)
    for r, evs in out.items():
        p = prompts[r // 3]
        seq = p + [t for t, _ in evs]
        tokens[r, :len(seq)] = seq
        mask[r, len(p):len(seq)] = 1.0
        beh[r, len(p):len(seq)] = [lp for _, lp in evs]
    rewards = np.array([np.mean([t % 2 == 0 for t, _ in out[r]])
                        for r in range(rid)], np.float32)
    adv = grpo.group_normalized_advantages(rewards, {0: [0, 1, 2],
                                                     1: [3, 4, 5]})
    batch = _tbatch({"tokens": tokens, "response_mask": mask,
                     "advantages": adv, "behavior_logprobs": beh})
    assert mask.sum() == sum(map(len, out.values())) > 6   # EOS may end one
    _, metrics = grpo.grpo_loss(params, cfg, batch)
    assert abs(float(metrics["ratio_mean"]) - 1.0) <= 1e-4
    lp, _ = grpo.policy_logprobs(params, cfg, batch["tokens"])
    assert float(((lp - batch["behavior_logprobs"]).abs()
                  * batch["response_mask"]).max()) <= 1e-4


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    args = ["--arch", "qwen3-8b", "--reduced", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    train_cli.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "step    1" in out and out.rstrip().endswith("done")
    train_cli.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "[restart] resumed from step 2" in out and "step    2" in out
    assert "step    0" not in out
    # the checkpoint resumes onto a 1 x 2 mesh: two ranks the command
    # spawns (gloo on the CPU), in a process of its own
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--steps", "4", "--model", "2"], capture_output=True, text=True,
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root / "src")),
        timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "[restart] resumed from step 3" in run.stdout
    assert "step    3" in run.stdout and run.stdout.rstrip().endswith("done")
