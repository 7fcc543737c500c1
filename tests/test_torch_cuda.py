"""The port's CUDA kernels against their plain versions, on the card.

Runs where the card is and JAX is not: this file imports only torch,
numpy, pytest and ``repro_torch``, and needs no conftest:

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py

Inputs come from numpy seeds.  It holds every hand-written kernel against
its plain PyTorch version (``repro_torch.kernels.ref``) on the same inputs:
the paged decode and prefill, the slab decode and the flash attention
(f32 at atol 2e-5; bf16 at the reference test's 1e-2, 2e-2 abs + rel for
flash, whose tensor-core path rounds P to bf16, and 2e-2 or one bf16 ulp
of the value for the paged prefill, whose tensor-core path rounds the f32
pool to TF32 and P to bf16), the SSD scan (a
relative 2e-5 / 4e-2 on y and state), the dequant (atol = rtol = 1e-6) and
an install that launches it once per int8-coded leaf.  Beyond the cases of
the other ``test_torch_*`` files' ``cuda`` tests it takes the paged decode
and prefill at G = 5, 6 and 7 (the prefill also at C = 1 and ragged C),
the flash attention at d = 32, 64 and 128 with a ragged S, a window and a
softcap, the slab decode with empty rows, a window and more splits than
live slots, and the SSD scan at both served prefills (8 ragged rows of
1152), with L < chunk and with a right-padded row whose state must equal
the unpadded row's bit for bit; it checks that repeated launches are
bit-identical, and
that the paged decode's outputs do not move by a bit when the table
doubles or rows are added.  The engine's decode horizon as a CUDA graph,
on a tiny dense and a tiny hybrid config: replayed tokens and logprobs
bit-equal to eager H=8 and to eager H=1 at temperature 0 and 1, and
across a ``swap_weights`` mid-stream; the decode kernels' launch counters
equal layers x H x horizons with replays; a capture that fails raises
(last in the file: a failed capture may leave the capture stream's
allocator state behind).  Whether a card exists is decided in a fixture,
so every process collects the same tests; without one they skip.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import tokenizer as tok
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention, plan_splits
from repro_torch.kernels.dequant import fused_dequant
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.paged_prefill import paged_prefill_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.transformer import init_params
from repro_torch.rl.sampler import request_key
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import InferenceEngine
from repro_torch.transfer.chunkstore import (ChunkStore, assemble_manifest,
                                             flatten_params)

TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# the paged prefill's bf16 gate (chip_smoke.py's one rule): 2e-2, or one
# bf16 ulp of |want| where that is larger: its tensor-core products round
# the f32 pool to TF32 and P to bf16, and the bf16 output then lands up to
# one ulp of its own magnitude from the plain version's
PREFILL_BF16_TOL, BF16_ULP = 2e-2, 2 ** -7
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 2e-5, "bfloat16": 4e-2}
DEQUANT_TOL = dict(atol=1e-6, rtol=1e-6)
KV_DTYPES = [("float32", "float32"), ("bfloat16", "float32"),
             ("bfloat16", "bfloat16")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _th(a, dtype, device):
    t = torch.from_numpy(a)
    if a.dtype == np.float32:
        t = t.to(getattr(torch, dtype))
    return t.to(device)


def _err(got, want):
    return float((got.float().cpu() - want.float().cpu()).abs().max())


# ------------------------------ paged decode ------------------------------ #
def _decode_inputs(B, H, K, ps, nb, d, seed=5):
    rs = np.random.RandomState(seed)
    P = 1 + B * nb                               # page 0 = garbage
    q = rs.randn(B, H, d).astype(np.float32)
    kp = rs.randn(P, ps, K, d).astype(np.float32)
    vp = rs.randn(P, ps, K, d).astype(np.float32)
    bt = (rs.permutation(P - 1)[:B * nb] + 1).reshape(B, nb).astype(np.int32)
    edge = [0, ps, ps + 1, nb * ps]
    lens = np.asarray((edge + list(rs.randint(1, nb * ps + 1, size=B)))[:B],
                      np.int32)
    return q, kp, vp, bt, lens


DECODE_CASES = [(4, 4, 2, 16, 8, 64, 0.0), (3, 32, 8, 16, 24, 128, 0.0),
                (3, 4, 1, 8, 16, 128, 30.0), (2, 16, 2, 16, 4, 64, 0.0),
                # G = 5, 6, 7: qwen3-32b, qwen3-14b and qwen2-7b's groups
                (4, 40, 8, 16, 24, 128, 0.0), (4, 48, 8, 16, 24, 128, 0.0),
                (4, 28, 4, 16, 24, 128, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", KV_DTYPES)
@pytest.mark.parametrize("B,H,K,ps,nb,d,cap", DECODE_CASES)
def test_decode_kernel_matches_plain_on_card(cuda, B, H, K, ps, nb, d, cap,
                                             qdt, kvdt):
    """Row 0 empty, rows ending at and past a page boundary, a full table;
    a second launch bit-identical."""
    q, kp, vp, bt, lens = _decode_inputs(B, H, K, ps, nb, d)
    args = (_th(q, qdt, cuda), _th(kp, kvdt, cuda), _th(vp, kvdt, cuda),
            _th(bt, qdt, cuda), _th(lens, qdt, cuda))
    got = paged_decode_attention(*args, cap=cap)
    again = paged_decode_attention(*args, cap=cap)
    torch.cuda.synchronize()
    want = ref.paged_decode_attention_ref(*args, cap=cap)
    assert _err(got, want) <= TOL[qdt]
    assert float(got[0].abs().max()) == 0.0
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", KV_DTYPES)
@pytest.mark.parametrize("B,H,K,ps,nb,d,cap", DECODE_CASES)
def test_decode_split_is_fixed_in_position_space_on_card(cuda, B, H, K, ps,
                                                         nb, d, cap, qdt,
                                                         kvdt):
    """The same rows with the table padded to 2 nb with page 0 and three
    rows appended (a full doubled table, one position, a mid-page length)
    give bit-identical outputs: a row's splits are fixed in position space,
    so its result depends on its own length and data alone."""
    q, kp, vp, bt, lens = _decode_inputs(B, H, K, ps, nb, d)
    rs = np.random.RandomState(7)
    bt_x = np.concatenate([
        np.concatenate([bt, np.zeros_like(bt)], 1),
        rs.randint(1, kp.shape[0], size=(3, 2 * nb)).astype(np.int32)])
    q_x = np.concatenate([q, rs.randn(3, H, d).astype(np.float32)])
    lens_x = np.concatenate([lens, np.asarray([2 * nb * ps, 1, ps + 3],
                                              np.int32)])
    pools = (_th(kp, kvdt, cuda), _th(vp, kvdt, cuda))
    got = paged_decode_attention(_th(q, qdt, cuda), *pools,
                                 _th(bt, qdt, cuda), _th(lens, qdt, cuda),
                                 cap=cap)
    args_x = (_th(q_x, qdt, cuda), *pools, _th(bt_x, qdt, cuda),
              _th(lens_x, qdt, cuda))
    grown = paged_decode_attention(*args_x, cap=cap)
    torch.cuda.synchronize()
    assert torch.equal(grown[:B], got)
    assert _err(grown, ref.paged_decode_attention_ref(*args_x, cap=cap)) \
        <= TOL[qdt]


# ------------------------------ paged prefill ----------------------------- #
def _prefill_inputs(B, C, H, K, ps, nb, d, seed=17):
    rs = np.random.RandomState(seed)
    P = 1 + B * nb
    q = rs.randn(B, C, H, d).astype(np.float32)
    k = rs.randn(B, C, K, d).astype(np.float32)
    v = rs.randn(B, C, K, d).astype(np.float32)
    kp = rs.randn(P, ps, K, d).astype(np.float32)
    vp = rs.randn(P, ps, K, d).astype(np.float32)
    bt = (rs.permutation(P - 1)[:B * nb] + 1).reshape(B, nb).astype(np.int32)
    offs = np.asarray([0, ps // 2 + 1, ps, nb * ps][:B], np.int32)
    cls = np.asarray([0, C, max(C - 3, 1), max(C // 2, 1)][:B], np.int32)
    return q, k, v, kp, vp, bt, offs, cls


PREFILL_CASES = [(4, 96, 4, 2, 8, 6, 64, 0.0),
                 # a single-query chunk at Qwen3-8B's heads
                 (4, 1, 32, 8, 16, 24, 128, 0.0),
                 (4, 256, 32, 8, 16, 24, 128, 0.0),
                 (3, 128, 8, 8, 16, 8, 128, 30.0),
                 (2, 200, 16, 1, 16, 4, 64, 0.0),
                 # G = 5, 6, 7: qwen3-32b, qwen3-14b and qwen2-7b's groups
                 (4, 256, 40, 8, 16, 24, 128, 0.0),
                 (4, 256, 48, 8, 16, 24, 128, 0.0),
                 (3, 130, 28, 4, 16, 8, 128, 20.0),
                 (2, 77, 7, 1, 16, 6, 64, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", KV_DTYPES)
@pytest.mark.parametrize("B,C,H,K,ps,nb,d,cap", PREFILL_CASES)
def test_prefill_kernel_matches_plain_on_card(cuda, B, C, H, K, ps, nb, d,
                                              cap, qdt, kvdt):
    """f32 within 2e-5; bf16 q within the one gate (PREFILL_BF16_TOL or one
    bf16 ulp of |want|); C = 1 and ragged C; a second launch
    bit-identical."""
    q, k, v, kp, vp, bt, offs, cls = _prefill_inputs(B, C, H, K, ps, nb, d)
    args = (_th(q, qdt, cuda), _th(k, qdt, cuda), _th(v, qdt, cuda),
            _th(kp, kvdt, cuda), _th(vp, kvdt, cuda), _th(bt, qdt, cuda),
            _th(offs, qdt, cuda), _th(cls, qdt, cuda))
    got = paged_prefill_attention(*args, cap=cap)
    again = paged_prefill_attention(*args, cap=cap)
    torch.cuda.synchronize()
    want = ref.paged_prefill_attention_ref(*args, cap=cap)
    assert not torch.isnan(got.float()).any()
    if qdt == "float32":
        assert _err(got, want) <= TOL[qdt]
    else:
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= torch.clamp(BF16_ULP * want.float().abs(),
                                         min=PREFILL_BF16_TOL)).all())
    assert float(got[0].abs().max()) == 0.0
    assert torch.equal(again, got)


# ------------------------------- slab decode ------------------------------ #
def _slab_inputs(B, H, K, T, d, seed=1):
    rs = np.random.RandomState(seed)
    lens = np.asarray(([1, T] + list(rs.randint(1, T + 1, size=B)))[:B],
                      np.int32)
    return (rs.randn(B, H, d).astype(np.float32),
            rs.randn(B, K, T, d).astype(np.float32),
            rs.randn(B, K, T, d).astype(np.float32), lens)


SLAB_CASES = [(2, 4, 2, 256, 64, 0, 0.0), (1, 8, 8, 256, 64, 64, 0.0),
              (3, 4, 1, 128, 128, 0, 30.0), (2, 16, 4, 512, 64, 0, 0.0),
              (3, 10, 2, 128, 64, 0, 20.0), (8, 25, 5, 1024, 64, 0, 0.0),
              (2, 32, 1, 96, 128, 40, 0.0),
              # zero-length rows, windows, more splits than live slots
              (6, 8, 2, 40, 64, 0, 0.0), (5, 25, 5, 1024, 64, 256, 0.0),
              (4, 6, 3, 3, 128, 2, 10.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", KV_DTYPES)
@pytest.mark.parametrize("B,H,K,T,d,window,cap", SLAB_CASES)
def test_slab_decode_kernel_matches_plain_on_card(cuda, B, H, K, T, d,
                                                  window, cap, qdt, kvdt):
    """Head-major slabs and [B, T, K, d] rings read as views; row 0 empty,
    every other odd row of one slot; repeated launches bit-identical."""
    q, k, v, lens = _slab_inputs(B, H, K, T, d)
    lens[0] = 0
    lens[3::2] = 1
    args = (_th(q, qdt, cuda), _th(k, kvdt, cuda), _th(v, kvdt, cuda),
            _th(lens, qdt, cuda))
    opts = dict(window=window, cap=cap)
    want = ref.decode_attention_ref(*args, **opts)
    got = decode_attention(*args, **opts)
    ring = [a.transpose(1, 2).contiguous().transpose(1, 2)
            for a in args[1:3]]
    got2 = decode_attention(args[0], *ring, args[3], **opts)
    again = decode_attention(*args, **opts)
    torch.cuda.synchronize()
    for g in (got, got2):
        assert _err(g, want) <= TOL[qdt]
        assert float(g[0].float().abs().max()) == 0.0
    assert torch.equal(again, got)


def test_slab_cases_split_past_their_live_slots():
    """On an H100 SXM's 132 SMs the split planner gives some SLAB_CASES
    more splits than a row has live slots (rows of 0 and 1 slots, T = 3),
    and others one split."""
    splits = {c: plan_splits(c[0], c[2], c[3], 132) for c in SLAB_CASES}
    assert splits[(4, 6, 3, 3, 128, 2, 10.0)] == 1
    assert max(splits.values()) > 1
    assert splits[(5, 25, 5, 1024, 64, 256, 0.0)] >= 2


# ----------------------------- flash attention ---------------------------- #
def _flash_inputs(B, H, K, S, d, seed=11):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, S, d).astype(np.float32),
            rs.randn(B, K, S, d).astype(np.float32),
            rs.randn(B, K, S, d).astype(np.float32))


FLASH_CASES = [(2, 4, 2, 256, 64, True, 0, 0.0),
               (1, 4, 4, 256, 64, True, 64, 0.0),
               (2, 2, 1, 128, 32, True, 0, 50.0),
               (1, 8, 2, 256, 128, False, 0, 0.0),
               (1, 2, 2, 512, 64, True, 128, 30.0),
               (2, 4, 2, 200, 64, True, 48, 20.0),
               (1, 10, 2, 256, 64, True, 64, 0.0),
               (10, 32, 8, 374, 128, True, 0, 0.0),
               (2, 16, 2, 130, 128, False, 0, 0.0),
               (2, 25, 5, 1152, 64, True, 1024, 0.0),
               # d = 32 / 64 / 128 with a ragged S, a window and a softcap
               (2, 6, 2, 77, 32, True, 20, 15.0),
               (1, 6, 3, 301, 64, False, 100, 25.0),
               (2, 8, 1, 259, 128, True, 130, 40.0),
               (1, 4, 4, 1, 128, True, 0, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,d,causal,window,cap", FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(cuda, B, H, K, S, d, causal,
                                            window, cap, dtype):
    """Head-major inputs and the model's [B, S, H, d] layout as views;
    atol = rtol as the reference's test holds its kernel: the tensor-core
    path rounds P to bf16, so an output may land one bf16 ulp away.
    Repeated launches bit-identical."""
    opts = dict(causal=causal, window=window, cap=cap)
    args = [_th(a, dtype, cuda) for a in _flash_inputs(B, H, K, S, d)]
    want = ref.flash_attention_ref(*args, **opts).float().cpu()
    got = flash_attention(*args, **opts)
    bshd = [a.transpose(1, 2).contiguous().transpose(1, 2) for a in args]
    got2 = flash_attention(*bshd, **opts)
    again = flash_attention(*args, **opts)
    torch.cuda.synchronize()
    assert got2.transpose(1, 2).is_contiguous()
    tol = FLASH_TOL[dtype]
    for g in (got, got2):
        assert bool(((g.float().cpu() - want).abs()
                     <= tol + tol * want.abs()).all())
    assert torch.equal(again, got)


# --------------------------------- SSD scan ------------------------------- #
def _ssd_inputs(b, L, H, G, P, N, seed=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, L, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(b, L, H))).astype(np.float32)
    A = (-np.exp(rs.randn(H) * 0.3)).astype(np.float32)
    B = rs.randn(b, L, G, N).astype(np.float32)
    C = rs.randn(b, L, G, N).astype(np.float32)
    return x, dt, A, B, C


def _rel(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / (float(want.abs().max())
                                              + 1e-6)


# the served prefills (chip_smoke.py SSD_HYMBA, SSD_MAMBA2_SERVE): 8 rows
# of 1152 with dt = 0 past each row's true length
SSD_HYMBA_LENS = (210, 395, 580, 740, 905, 1000, 1090, 1150)
SSD_CASES = [(2, 128, 4, 1, 64, 32, 32), (1, 256, 8, 2, 32, 64, 64),
             (2, 64, 2, 2, 16, 16, 16), (1, 128, 24, 1, 64, 128, 64),
             (2, 200, 50, 1, 64, 16, 64), (1, 77, 6, 3, 32, 16, 32),
             (8, 1152, 50, 1, 64, 16, 64), (8, 1152, 24, 1, 64, 128, 64),
             (2, 40, 4, 1, 64, 32, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,L,H,G,P,N,chunk", SSD_CASES)
def test_ssd_kernel_matches_plain_on_card(cuda, b, L, H, G, P, N, chunk,
                                          dtype):
    """Contiguous inputs and the model's strided slices of one conv
    output, ragged L, a single chunk (L < chunk) and the served prefills'
    ragged rows included; A stays f32; a second launch is bit-identical."""
    x, dt, A, B, C = _ssd_inputs(b, L, H, G, P, N)
    if L == 1152:
        dt = dt * (np.arange(L)[None, :, None]
                   < np.array(SSD_HYMBA_LENS)[:, None, None])
    args = [torch.from_numpy(a) if i == 2 else
            torch.from_numpy(a).to(getattr(torch, dtype))
            for i, a in enumerate((x, dt.astype(np.float32), A, B, C))]
    args = [t.to(cuda) for t in args]
    yr, sr = ref.ssd_scan_ref(*args)
    y, st = ssd_scan(*args, chunk=chunk)
    again = ssd_scan(*args, chunk=chunk)
    assert torch.equal(again[0], y) and torch.equal(again[1], st)
    x, dt, A, B, C = args
    xbc = torch.cat([x.reshape(b, L, H * P), B.reshape(b, L, G * N),
                     C.reshape(b, L, G * N)], dim=-1)
    views = (xbc[..., :H * P].reshape(b, L, H, P), dt, A,
             xbc[..., H * P:H * P + G * N].reshape(b, L, G, N),
             xbc[..., H * P + G * N:].reshape(b, L, G, N))
    y2, st2 = ssd_scan(*views, chunk=chunk)
    torch.cuda.synchronize()
    for got, want in ((y, yr), (st, sr), (y2, yr), (st2, sr)):
        assert _rel(got, want) < SSD_TOL[dtype]


@pytest.mark.cuda
def test_ssd_kernel_right_padded_row_keeps_its_state_bit_exact(cuda):
    """A row of 50 positions right-padded to 200 with dt = 0 (x, B and C
    left as they are, as the model pads) ends in the unpadded row's state
    bit for bit, and its first 50 outputs are the unpadded row's."""
    x, dt, A, B, C = _ssd_inputs(1, 200, 6, 3, 64, 32, seed=5)
    dt[:, 50:] = 0.0
    full = [torch.from_numpy(a).to(cuda) for a in (x, dt, A, B, C)]
    cut = [t[:, :50] if t.dim() > 1 else t for t in full]
    y, st = ssd_scan(*full, chunk=64)
    y_cut, st_cut = ssd_scan(*cut, chunk=64)
    torch.cuda.synchronize()
    assert torch.equal(st, st_cut) and torch.equal(y[:, :50], y_cut)


# ---------------------------------- dequant ------------------------------- #
def _dequant_inputs(R, C, base, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randint(-127, 128, (R, C)).astype(np.int8)
    scale = rng.uniform(1e-4, 1e-2, (C,)).astype(np.float32)
    b = rng.randn(R, C).astype(np.float32) if base else None
    return q, scale, b


@pytest.mark.cuda
@pytest.mark.parametrize("base", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("R,C", [(8, 16), (100, 37), (256, 128), (1, 5),
                                 (4096, 1), (33, 12288)])
def test_dequant_kernel_matches_plain_on_card(cuda, R, C, base):
    q, scale, b = _dequant_inputs(R, C, base)
    args = [torch.from_numpy(q).to(cuda), torch.from_numpy(scale).to(cuda),
            None if b is None else
            torch.from_numpy(b).to(cuda, getattr(torch, base))]
    before = fused_dequant.launches
    got = ops.fused_dequant(*args)
    torch.cuda.synchronize()
    assert fused_dequant.launches == before + 1
    want = ref.dequant_ref(*args)
    torch.testing.assert_close(got, want, **DEQUANT_TOL)


def _tree_map(tree, fn):
    return {k: _tree_map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _stores():
    """A chunk store holding v1 (the port's reduced bf16 qwen3-8b, seeded)
    and v2 = v1 + 0.01 N(0, 1) cast back to each leaf's dtype."""
    cfg = get_config("qwen3-8b").reduced(vocab_size=tok.VOCAB_SIZE,
                                         dtype="bfloat16")
    p1 = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(1)
    p2 = _tree_map(p1, lambda t: (t.float() + torch.from_numpy(
        0.01 * rng.randn(*t.shape).astype(np.float32))).to(t.dtype))
    store = ChunkStore(4096)
    store.publish(1, p1)
    store.publish(2, p2)
    return store, p1


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["int8", "delta-int8"])
def test_install_on_card_launches_once_per_int8_leaf(cuda, codec):
    store, p1 = _stores()
    like = _tree_map(p1, lambda t: t.to(cuda))
    m = store.manifest(2, codec, base_version=1)
    chunks = {c.digest: store.fetch(c.digest) for c in m.chunks}
    before = fused_dequant.launches
    got = flatten_params(store.assemble(m, chunks, like=like,
                                        base_params=like))
    assert fused_dequant.launches - before == len(m.leaves)
    host = flatten_params(assemble_manifest(m, chunks, like=p1,
                                            base_params=p1))
    for k in host:
        torch.testing.assert_close(got[k].float().cpu(), host[k].float(),
                                   **DEQUANT_TOL)


# ----------------------- the decode horizon as a graph ----------------------- #
def _graph_cfg(family):
    """Tiny f32 configs whose head dim the decode kernels take (64)."""
    kw = dict(vocab_size=tok.VOCAB_SIZE, d_model=128, n_heads=4,
              n_kv_heads=2, head_dim=64, d_ff=256)
    if family == "dense":
        return get_config("qwen3-8b").reduced(name="tiny-graph-dense", **kw)
    return get_config("hymba-1.5b").reduced(name="tiny-graph-hybrid", **kw)


def _graph_params(cfg, seed, device):
    return init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                       device)


def _graph_prompts(seed=4):
    rs = np.random.RandomState(seed)
    return [[tok.BOS] + rs.randint(3, tok.VOCAB_SIZE, n - 1).tolist()
            for n in (20, 37, 11)]


def _graph_serve(cfg, params, *, horizon, temperature, graphs, swap=None):
    """Three singles to completion; ``swap`` = (after this many steps,
    params) installs version 1 mid-stream.  Returns ({rid: [(token,
    logprob, version)]}, engine)."""
    eng = InferenceEngine(cfg, params, max_batch=4, slab_len=64,
                          page_size=16, temperature=temperature,
                          horizon=horizon, device="cuda", cuda_graphs=graphs)
    prompts = _graph_prompts()
    for rid, p in enumerate(prompts):
        eng.add_request(rid, p, request_key(3, rid), len(p) + 30, len(p))
    out = {rid: [] for rid in range(len(prompts))}
    done, n = set(), 0
    while len(done) < len(prompts):
        for e in eng.step():
            out[e.req_id].append((e.token, e.logprob, e.weight_version))
            if e.finished:
                done.add(e.req_id)
        n += 1
        assert n < 200, "requests did not finish"
        if swap is not None and n == swap[0]:
            eng.swap_weights(swap[1], 1)
    return out, eng


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_graph_horizon_bit_equal_to_eager_on_card(cuda, family, temperature):
    cfg = _graph_cfg(family)
    params = _graph_params(cfg, 0, cuda)
    got, eng = _graph_serve(cfg, params, horizon=8, temperature=temperature,
                            graphs=True)
    assert eng.graph_capture_s, "no horizon was captured"
    assert all(e.graph is not None for e in eng._graphs.values())
    eager8, _ = _graph_serve(cfg, params, horizon=8, temperature=temperature,
                             graphs=False)
    eager1, _ = _graph_serve(cfg, params, horizon=1, temperature=temperature,
                             graphs=False)
    assert got == eager8
    assert got == eager1


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_graph_horizon_across_a_swap_on_card(cuda, family):
    cfg = _graph_cfg(family)
    p0, p1 = _graph_params(cfg, 0, cuda), _graph_params(cfg, 1, cuda)
    inv = engine_mod.graph_cache_stats()["invalidations"]
    got, eng = _graph_serve(cfg, p0, horizon=8, temperature=1.0, graphs=True,
                            swap=(3, p1))
    assert engine_mod.graph_cache_stats()["invalidations"] == inv + 1
    want, _ = _graph_serve(cfg, p0, horizon=8, temperature=1.0,
                           graphs=False, swap=(3, p1))
    assert got == want
    assert {v for evs in got.values() for *_, v in evs} == {0, 1}


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_graph_launch_counters_count_replays_on_card(cuda, family):
    cfg = _graph_cfg(family)
    kernel = (paged_decode_attention if family == "dense"
              else decode_attention)
    before = kernel.launches
    s0 = engine_mod.graph_cache_stats()
    _, eng = _graph_serve(cfg, _graph_params(cfg, 0, cuda), horizon=8,
                          temperature=0.0, graphs=True)
    s1 = engine_mod.graph_cache_stats()
    assert s1["replays"] > s0["replays"] and s1["captures"] > s0["captures"]
    assert kernel.launches - before == \
        cfg.n_layers * eng.horizon * eng.n_decode_dispatches


@pytest.mark.cuda
def test_failed_capture_raises_on_card(cuda, monkeypatch):
    """A body that syncs with the host cannot be captured: the capture
    raises and nothing falls back to the eager horizon."""
    token_logprob = engine_mod.token_logprob

    def syncing(logits, tokens, temperature):
        logits.sum().item()
        return token_logprob(logits, tokens, temperature)
    monkeypatch.setattr(engine_mod, "token_logprob", syncing)
    cfg = _graph_cfg("dense")
    with pytest.raises(RuntimeError):
        _graph_serve(cfg, _graph_params(cfg, 0, cuda), horizon=4,
                     temperature=0.0, graphs=True)
