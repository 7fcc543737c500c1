"""Every registered family trains in the port as the reference trains it, on
the CPU, in f32.

The reference's ``init_params`` is carried into the port with
``params_from_numpy`` and the batches are made with numpy from a seed, for
the six configs the dense Qwen tests do not cover, all ``.reduced()``:
the hybrid ``hymba-1.5b`` and the SSM ``mamba2-130m`` (whose scan the
port differentiates), ``gemma3-4b`` and ``gemma2-27b`` (sliding windows,
softcaps, post norms), ``llava-next-34b`` (GRPO on embeddings and tokens)
and the encoder ``hubert-xlarge`` (bidirectional, ``supervised_loss``).
Loss and gradients against ``jax.value_and_grad``; three train steps
against the reference's; the embeds forward in train and prefill; the
ported ``ssd_chunked`` and the CUDA scan's backward rule against the
reference's ``ssd_chunked``; the two new configs in the registry; the
train and serve CLIs.  Each tolerance is stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.models import init_params as jax_init_params
from repro.models import kv_cache as jkvc
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro.models.transformer import CPU_RT
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import logits_from_hidden as jax_logits
from repro.rl import grpo as jax_grpo
from repro_torch.configs import get_config
from repro_torch.configs.base import list_archs
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import kv_cache as kvc
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.ssm import ssd_chunked
from repro_torch.models.transformer import forward, logits_from_hidden
from repro_torch.rl import grpo

ARCHS = ["hymba-1.5b", "mamba2-130m", "gemma3-4b", "gemma2-27b",
         "llava-next-34b", "hubert-xlarge"]
# f32 sums in another order over a few layers: the loss within 1e-5 of
# its value, every gradient leaf within 1e-4 of its largest |value|.  A
# GRPO loss is a masked mean of +-advantage-weighted ratios of order 1
# that largely cancel (mamba2-130m's is 5e-3), so its rounding is that of
# terms of order 1: the loss is held to 1e-5 x max(|loss|, 1)
LOSS_REL_TOL = 1e-5
GRAD_REL_TOL = 1e-4


# S passes the reduced windows of 16 and the reference's SSD chunk of 32
B, S = 4, 40


def _loss_close(got, want):
    return abs(float(got) - float(want)) <= \
        LOSS_REL_TOL * max(abs(float(want)), 1.0)


def _models(arch, seed=3):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _batch(cfg, seed=1):
    """The launcher's layout (``launch.train.synthetic_batch``) drawn with
    numpy: embeddings for an ``embeds`` config; for a decoder tokens,
    ragged response masks, advantages and behaviour logprobs near the
    policy's own (so some ratios clip); for the encoder labels under a
    random mask."""
    rs = np.random.RandomState(seed)
    b = {}
    if cfg.input_mode == "embeds":
        b["embeds"] = rs.randn(B, S, cfg.d_model).astype(np.float32)
    if cfg.is_decoder:
        mask = np.zeros((B, S), np.float32)
        for i in range(B):
            mask[i, 5 + i:S - i] = 1.0
        b.update(tokens=rs.randint(3, cfg.vocab_size, (B, S)).astype(np.int32),
                 response_mask=mask,
                 advantages=rs.randn(B).astype(np.float32),
                 behavior_logprobs=(-np.log(cfg.vocab_size)
                                    + 0.3 * rs.randn(B, S)).astype(np.float32))
    else:
        b.update(labels=rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
                 mask=(rs.rand(B, S) < 0.6).astype(np.float32))
    return b


def _to_np(tree):
    return {k: _to_np(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in tree.items()}


def _jloss(jcfg, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if jcfg.is_decoder:
        return lambda p: jax_grpo.grpo_loss(p, jcfg, CPU_RT, jb)
    return lambda p: jax_grpo.supervised_loss(p, jcfg, CPU_RT, jb)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """The loss and every gradient leaf (the port with per-layer remat, as
    the launcher trains); llava's ``embed``, unread when the batch brings
    embeddings, gets the reference's zero gradient."""
    jcfg, jparams, cfg, params = _models(arch)
    b = _batch(cfg)
    (jl, _), jg = jax.value_and_grad(_jloss(jcfg, b), has_aux=True)(jparams)
    loss, _, grads = grpo.loss_and_grads(
        params, cfg, {k: torch.from_numpy(v) for k, v in b.items()},
        remat=True)
    assert _loss_close(loss, jl)
    got, want = jax.tree.leaves(_to_np(grads)), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= GRAD_REL_TOL * np.abs(w).max()
    if arch == "llava-next-34b":
        assert not grads["embed"].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    """Three steps (lr 1e-3) from the same weights on three batches, as
    ``test_torch_train.py`` holds the dense family: losses as above;
    every param element within 1e-4 of the reference's and 99% within
    1e-6.  Adam's step g / (|g| + eps) is ill-conditioned where
    |g| is near eps = 1e-8 (gradients of pure rounding noise, such as
    a k bias's), so there f32 sums in another order move a step by a few
    percent of lr."""
    jcfg, jparams, cfg, params = _models(arch)
    jstep = jax.jit(jax_grpo.make_train_step(
        jcfg, CPU_RT, lr=1e-3,
        loss_kind="grpo" if jcfg.is_decoder else "supervised"))
    step = grpo.make_train_step(cfg, lr=1e-3, remat=True)
    jstate = jax_grpo.init_train_state(jparams)
    state = grpo.init_train_state(params, "cpu")
    for i in range(3):
        b = _batch(cfg, seed=10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert _loss_close(m["loss"], jm["loss"])
        assert np.isfinite(float(m["grad_norm"]))
    assert int(state["opt"]["count"]) == 3
    diffs = np.concatenate([
        np.abs(a - np.asarray(w)).ravel() for a, w in
        zip(jax.tree.leaves(_to_np(state["params"])),
            jax.tree.leaves(jstate["params"]))])
    assert diffs.max() <= 1e-4 and (diffs > 1e-6).mean() <= 1e-2


@pytest.mark.parametrize("arch", ["llava-next-34b", "hubert-xlarge"])
def test_train_forward_on_embeds_matches_reference(arch):
    """Final hidden states of the train forward on embeddings (hubert's
    bidirectional attention included), within 1e-4 (f32)."""
    jcfg, jparams, cfg, params = _models(arch)
    e = np.random.RandomState(7).randn(2, 33, cfg.d_model).astype(np.float32)
    want = jax_forward(jparams, jcfg, CPU_RT, embeds=jnp.asarray(e),
                       mode="train")["hidden"]
    got = forward(params, cfg, embeds=torch.from_numpy(e), mode="train")
    assert np.abs(got["hidden"].numpy() - np.asarray(want)).max() <= 1e-4


def test_llava_prefill_on_embeds_then_decode_matches_reference():
    """Two paged prefill chunks of embeddings (the second reads the first
    from the pool; ragged lengths), then two decode steps of tokens
    through the embedding table: logits within 1e-4 (f32)."""
    jcfg, jparams, cfg, params = _models("llava-next-34b")
    Bp, C, ps, nb = 3, 16, 8, 6
    rs = np.random.RandomState(0)
    chunks = [rs.randn(Bp, C, cfg.d_model).astype(np.float32)
              for _ in range(2)]
    lens = [np.array([13, 16, 5], np.int32), np.array([9, 4, 0], np.int32)]
    dec = [rs.randint(3, cfg.vocab_size, (Bp,)).astype(np.int32)
           for _ in range(2)]
    bt = (rs.permutation(Bp * nb) + 1).reshape(Bp, nb).astype(np.int32)
    jcache = jkvc.init_paged_cache(jcfg, Bp, 1 + Bp * nb, ps,
                                   dtype=jnp.float32)
    cache = kvc.init_paged_cache(cfg, Bp, 1 + Bp * nb, ps, device="cpu")
    offs = np.zeros(Bp, np.int32)
    for e, n in zip(chunks, lens):
        mask = np.arange(C)[None] < n[:, None]
        jout = jax_forward(jparams, jcfg, CPU_RT, embeds=jnp.asarray(e),
                           seq_mask=jnp.asarray(mask, jnp.float32),
                           cache=jcache, mode="prefill",
                           paged={"block_tables": jnp.asarray(bt),
                                  "q_offsets": jnp.asarray(offs)})
        jcache = jout["cache"]
        out = forward(params, cfg, embeds=torch.from_numpy(e), cache=cache,
                      mode="prefill", seq_mask=torch.from_numpy(mask),
                      paged={"block_tables": torch.from_numpy(bt),
                             "q_offsets": torch.from_numpy(offs)})
        cache["pos"] = out["pos"]
        np.testing.assert_allclose(
            logits_from_hidden(params, cfg, out["hidden"]).numpy(),
            np.asarray(jax_logits(jparams, jcfg, jout["hidden"])), atol=1e-4,
            rtol=0)
        offs = offs + n
    np.testing.assert_array_equal(cache["pos"].numpy(), jcache["pos"])
    for t in dec:
        jout = jax_forward(jparams, jcfg, CPU_RT, tokens=jnp.asarray(t),
                           cache=jcache, mode="decode",
                           paged={"block_tables": jnp.asarray(bt)})
        jcache = jout["cache"]
        out = forward(params, cfg, tokens=torch.from_numpy(t), cache=cache,
                      mode="decode",
                      paged={"block_tables": torch.from_numpy(bt)})
        cache["pos"] = out["pos"]
        np.testing.assert_allclose(
            logits_from_hidden(params, cfg, out["hidden"]).numpy(),
            np.asarray(jax_logits(jparams, jcfg, jout["hidden"])), atol=1e-4,
            rtol=0)


def test_encoder_has_no_prefill_or_decode():
    """hubert has no decode step, so the port's forward refuses the cache
    modes (the reference's would fill a cache no decode ever reads)."""
    _, _, cfg, params = _models("hubert-xlarge")
    e = torch.zeros((1, 8, cfg.d_model))
    with pytest.raises(ValueError, match="encoder-only"):
        forward(params, cfg, embeds=e, mode="prefill", cache={})


# --------------------------------------------------------------------------- #
# the scan's gradient
# --------------------------------------------------------------------------- #
def _ssd_inputs(b, L, H, G, P, N, seed=2):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, L, H, P).astype(np.float32),
            np.log1p(np.exp(rs.randn(b, L, H))).astype(np.float32),
            (-np.exp(rs.randn(H) * 0.3)).astype(np.float32),
            rs.randn(b, L, G, N).astype(np.float32),
            rs.randn(b, L, G, N).astype(np.float32))


def _jax_ssd_grads(args, wy, ws, chunk, L):
    """jax.grad of sum(y * wy) + sum(state * ws) through the reference's
    ssd_chunked, L padded to the chunk as its mixer pads it (ws None: the
    state unused)."""
    pad = -L % chunk

    def loss(x, dt, A, B, C):
        padded = [jnp.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
                  for t in (x, dt, B, C)]
        y, st = jax_ssd_chunked(padded[0], padded[1], A, padded[2],
                                padded[3], chunk=chunk)
        out = jnp.sum(y[:, :L] * wy)
        return out + jnp.sum(st * ws) if ws is not None else out
    return jax.grad(loss, argnums=tuple(range(5)))(
        *(jnp.asarray(a) for a in args))


def _close(got, want, tol):
    want = np.asarray(want)
    return np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("b,L,H,G,P,N,chunk", [(2, 64, 4, 1, 16, 16, 32),
                                               (1, 96, 6, 3, 8, 16, 32),
                                               (2, 75, 4, 2, 16, 16, 32)])
def test_ssd_chunked_matches_reference(b, L, H, G, P, N, chunk):
    """y and the final state within 1e-5 of max |value|; gradients of both
    outputs within 1e-4 of each leaf's max |value| (f32).  A ragged L
    (75) is held to the reference's scan on the input padded to the
    chunk, as its mixer pads it."""
    args = _ssd_inputs(b, L, H, G, P, N)
    pad = -L % chunk
    want = jax_ssd_chunked(
        *(jnp.pad(jnp.asarray(a), [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
          if a.ndim > 1 else jnp.asarray(a) for a in args), chunk=chunk)
    got = ssd_chunked(*(torch.from_numpy(a) for a in args), chunk=chunk)
    for g, w in zip(got, (want[0][:, :L], want[1])):
        assert _close(g.numpy(), w, 1e-5)
    rs = np.random.RandomState(4)
    wy = rs.randn(b, L, H, P).astype(np.float32)
    ws = rs.randn(b, H, P, N).astype(np.float32)
    want = _jax_ssd_grads(args, wy, ws, chunk, L)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, st = ssd_chunked(*leaves, chunk=chunk)
    ((y * torch.from_numpy(wy)).sum() + (st * torch.from_numpy(ws)).sum()) \
        .backward()
    for t, w in zip(leaves, want):
        assert _close(t.grad.numpy(), w, GRAD_REL_TOL)


@pytest.mark.parametrize("use_state", [True, False])
def test_ssd_autograd_function_backward_rule(monkeypatch, use_state):
    """The CUDA path's autograd.Function, with the sequential plain scan
    standing in for its kernel (which runs only on the card), at a ragged
    L (the recompute pads it to the chunk): the forward equal to the plain
    scan's, one kernel call, and gradients within 1e-4 of each leaf's max
    |value| of jax.grad through the reference's ssd_chunked, with the
    final state's gradient and with the state unused (train mode)."""
    b, L, H, G, P, N, chunk = 2, 75, 4, 2, 16, 16, 32
    args = _ssd_inputs(b, L, H, G, P, N, seed=6)
    rs = np.random.RandomState(8)
    wy = rs.randn(b, L, H, P).astype(np.float32)
    ws = rs.randn(b, H, P, N).astype(np.float32) if use_state else None
    want = _jax_ssd_grads(args, wy, ws, chunk, L)
    calls = []

    def plain_kernel(*a, chunk):
        calls.append(chunk)
        return ref.ssd_scan_ref(*a)

    monkeypatch.setattr(ops, "_ssd_kernel", plain_kernel)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, st = ops._SSDScan.apply(*leaves, chunk)
    py, pst = ref.ssd_scan_ref(*leaves)
    assert torch.equal(y, py) and torch.equal(st, pst)
    loss = (y * torch.from_numpy(wy)).sum()
    if use_state:
        loss = loss + (st * torch.from_numpy(ws)).sum()
    loss.backward()
    assert calls == [chunk]
    for t, w in zip(leaves, want):
        assert _close(t.grad.numpy(), w, GRAD_REL_TOL)


# --------------------------------------------------------------------------- #
# configs and CLIs
# --------------------------------------------------------------------------- #
def test_registry_holds_every_reference_arch():
    """All thirteen of the reference's archs resolve in the port, with the
    reference's parameter count, decoder flag and input mode, as
    configured and reduced."""
    assert list_archs() == jax_list_archs()
    for arch in jax_list_archs():
        for cut in (False, True):
            want, got = jax_get_config(arch), get_config(arch)
            if cut:
                want, got = want.reduced(), got.reduced()
            assert got.param_count() == want.param_count(), arch
            assert (got.is_decoder, got.input_mode, got.causal,
                    got.family) == (want.is_decoder, want.input_mode,
                                    want.causal, want.family), arch
    hub, llava = get_config("hubert-xlarge"), get_config("llava-next-34b")
    assert not hub.is_decoder and hub.head_dim == 80
    assert llava.is_decoder and llava.n_heads // llava.n_kv_heads == 7
    assert hub.reduced().head_dim == 16 and hub.reduced().d_model == 64
    assert hub.reduced().dtype == llava.reduced().dtype == "float32"


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llava-next-34b"])
def test_train_cli_takes_the_embeds_configs(arch, capsys):
    train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--steps", "2"])
    out = capsys.readouterr().out
    assert "step    1" in out and out.rstrip().endswith("done")


def test_serve_cli_refuses_the_encoder(capsys):
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                        "cpu"])
    assert "encoder-only" in capsys.readouterr().err
