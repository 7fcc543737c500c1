"""The port's CUDA kernels against their plain versions, on the card.

Runs where the card is and JAX is not: this file imports only torch,
numpy, pytest and ``repro_torch``, and needs no conftest:

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py

Inputs come from numpy seeds.  It holds every hand-written kernel against
its plain PyTorch version (``repro_torch.kernels.ref``) on the same inputs:
the paged decode and prefill, the slab decode and the flash attention
(f32 at atol 2e-5; bf16 at the reference test's 1e-2, 2e-2 abs + rel for
flash, whose tensor-core path rounds P to bf16, and 2e-2 or one bf16 ulp
of the value for the paged prefill, whose tensor-core path takes an f32
pool as bf16 high and low halves and rounds P to bf16), the SSD scan (a
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
doubles or rows are added, nor the paged prefill's when the table
doubles, rows are added, C is padded or its prefix pieces fold in one
CTA (rows of several pieces, prefixes up to 4,096 positions); the paged
decode also at G = 1 (the MoE
configs' 16 / 16 heads); the four attention kernels at gemma3's head dim
of 256 and at gemma2's G = 2 with a softcap of 50, and a tiny gemma3's
decode horizon as a graph; the flash attention at hubert's d = 80
(bidirectional), and the gradients of ``ops.ssd`` (the forward and
backward kernels) against autograd through the plain scan; the two
backward kernels (``flash_attention_backward``, ``ssd_scan_backward``)
against autograd through the plain versions (bf16 within 2e-2, f32 and
the 3xTF32 scan within 1e-4 of each gradient's max |want|), bit-identical
on a second launch, on the model's strided views, and raising on inputs
they do not take; and at the (arch x shape) cells' lengths, the flash attention at S
= 32,768 (G = 7) and at S = 524,288 with a window (first and last 128
query rows against the plain attention of those rows), the slab decode
over decode_32k's slab of 32,896 slots, and the scan over 524,288
positions against the plain chunked scan run in segments; both decodes'
tensor-core body at G = 1, 2, 5, 7, 16 and 32 x d = 64 / 128 / 256 over
bf16 and f32 K/V (over f32 also within one bf16 ulp of the value), a long
bf16 slab split dozens of ways, and its rows unchanged when rows are
appended where the split cap sets the split count.  The MoE layer
with drops gives the same bits on
a second launch and the CPU's drop set.  The engine's decode horizon as a
CUDA graph, on a tiny dense, a tiny MoE and a tiny hybrid config: replayed tokens and logprobs
bit-equal to eager H=8 and to eager H=1 at temperature 0 and 1, and
across a ``swap_weights`` mid-stream; the decode kernels' launch counters
equal layers x H x horizons with replays; a capture that fails raises
(last in the file: a failed capture may leave the capture stream's
allocator state behind).  Whether a card exists is decided in a fixture,
so every process collects the same tests; without one they skip.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import tokenizer as tok
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (SPLIT_CAP, decode_attention,
                                                  plan_splits)
from repro_torch.kernels.dequant import fused_dequant
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_backward)
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.paged_prefill import paged_prefill_attention
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_backward
from repro_torch.models import moe
from repro_torch.models.transformer import init_params
from repro_torch.rl.sampler import request_key
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import InferenceEngine
from repro_torch.transfer.chunkstore import (ChunkStore, assemble_manifest,
                                             flatten_params)

TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# the paged prefill's bf16 gate (chip_smoke.py's one rule): 2e-2, or one
# bf16 ulp of |want| where that is larger: its tensor-core products round
# P to bf16, and the bf16 output then lands up to one ulp of its own
# magnitude from the plain version's
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
                (4, 28, 4, 16, 24, 128, 0.0),
                # G = 1: qwen2-moe-a2.7b and deepseek-moe-16b (16 / 16)
                (4, 16, 16, 16, 24, 128, 0.0)]


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
                 (2, 77, 7, 1, 16, 6, 64, 0.0),
                 # a later chunk of long prompts at Qwen3-8B's heads:
                 # offsets up to 4,096, a table of several prefix pieces
                 (4, 256, 32, 8, 16, 256, 128, 0.0)]


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


# rows of several prefix pieces at every head dim, G = 2 with a softcap,
# and G = 7
PREFILL_FIXED = [(4, 256, 32, 8, 16, 256, 128, 0.0),
                 (4, 130, 8, 4, 16, 80, 256, 0.0),
                 (4, 200, 32, 16, 16, 80, 128, 50.0),
                 (4, 77, 7, 1, 16, 70, 64, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("kvdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,C,H,K,ps,nb,d,cap", PREFILL_FIXED)
def test_prefill_row_is_fixed_on_card(cuda, B, C, H, K, ps, nb, d, cap,
                                      kvdt, monkeypatch):
    """bf16 q: a row's output is the same bits when its table widens with
    page 0, when rows are added, when C is padded, and when the wrapper
    folds the prefix pieces in one CTA instead of splitting them across
    CTAs (its scratch cap at 0); the last row's prefix has several pieces
    (split mode in the first call)."""
    import repro_torch.kernels.paged_prefill as pp
    q, k, v, kp, vp, bt, offs, cls = _prefill_inputs(B, C, H, K, ps, nb, d)
    assert offs[-1] > pp.PREFILL_SPLIT
    pools = [_th(a, kvdt, cuda) for a in (kp, vp)]

    def run(q_, k_, v_, bt_, o_, c_):
        out = paged_prefill_attention(
            *(_th(a, "bfloat16", cuda) for a in (q_, k_, v_)), *pools,
            *(_th(a, "bfloat16", cuda) for a in (bt_, o_, c_)), cap=cap)
        torch.cuda.synchronize()
        return out

    ctas = pp.max_ctas(cuda)
    assert pp.plan(B, C, H, d, nb, ps, ctas)[0] == "split"
    base = run(q, k, v, bt, offs, cls)
    wide = run(q, k, v, np.concatenate([bt, np.zeros_like(bt)], 1), offs,
               cls)
    assert torch.equal(wide, base)
    rs = np.random.RandomState(3)
    extra = lambda n, m: rs.randn(2, n, m, d).astype(np.float32)  # noqa
    grown = run(np.concatenate([q, extra(C, H)]),
                np.concatenate([k, extra(C, K)]),
                np.concatenate([v, extra(C, K)]),
                np.concatenate([bt, rs.randint(1, kp.shape[0], size=(
                    2, nb)).astype(np.int32)]),
                np.concatenate([offs, np.asarray([nb * ps - 5, 3],
                                                 np.int32)]),
                np.concatenate([cls, np.asarray([C, 1], np.int32)]))
    assert torch.equal(grown[:B], base)
    pad = lambda x: np.concatenate(  # noqa: E731
        [x, rs.randn(B, 37, *x.shape[2:]).astype(np.float32)], 1)
    padded = run(pad(q), pad(k), pad(v), bt, offs, cls)
    assert torch.equal(padded[:, :C], base)
    monkeypatch.setattr(pp, "SPLIT_SCRATCH_CAP", 0)
    assert pp.plan(B, C, H, d, nb, ps, ctas)[0] == "fold"
    assert torch.equal(run(q, k, v, bt, offs, cls), base)


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


# ------------- the decodes' tensor-core body (bf16 q), at every G ---------- #
# G = 1 (the MoE configs), 2 (gemma), 5 / 7 (Hymba, qwen2-7b), and 16 and 32,
# which fill one and two blocks of the 16 mma rows; d 64 / 128 / 256; over
# bf16 and f32 K/V.  Over f32 K/V the products are split TF32, so the bf16
# output also holds the rings' gate: one bf16 ulp of |want| + 2e-5.
MMA_GROUPS = [1, 2, 5, 7, 16, 32]


def _mma_gate(got, want, kvdt):
    assert _err(got, want) <= TOL["bfloat16"]
    if kvdt == "float32":
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= BF16_ULP * want.float().abs() + TOL["float32"])
                    .all())


@pytest.mark.cuda
@pytest.mark.parametrize("kvdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("G", MMA_GROUPS)
def test_mma_paged_decode_on_card(cuda, G, d, kvdt):
    """bf16 q over the paged pool at every G and head dim: q pre-scaled
    as the engine calls it, rows of 0, 1, a mid-tile length and the full
    table (several splits of SPLIT positions); a relaunch bit-identical."""
    B, K, ps, nb = 4, 2, 16, 12
    q, kp, vp, bt, lens = _decode_inputs(B, G * K, K, ps, nb, d, seed=31)
    lens[:] = [0, 1, 77, nb * ps]
    args = (_th(q * d ** -0.5, "bfloat16", cuda), _th(kp, kvdt, cuda),
            _th(vp, kvdt, cuda), _th(bt, "int32", cuda),
            _th(lens, "int32", cuda))
    got = paged_decode_attention(*args, scale=1.0)
    again = paged_decode_attention(*args, scale=1.0)
    torch.cuda.synchronize()
    _mma_gate(got, ref.paged_decode_attention_ref(*args, scale=1.0), kvdt)
    assert float(got[0].float().abs().max()) == 0.0
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("kvdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("G", MMA_GROUPS)
def test_mma_slab_decode_on_card(cuda, G, d, kvdt):
    """bf16 q over a [B, T, K, d] ring read as views at every G and head
    dim, with a window on one call: rows of 0, 1, a mid-tile length and
    the whole ring; a relaunch bit-identical."""
    B, K, T = 4, 2, 300
    q, k, v, lens = _slab_inputs(B, G * K, K, T, d, seed=32)
    lens[:] = [0, 1, 77, T]
    q = _th(q * d ** -0.5, "bfloat16", cuda)
    k, v = (_th(a, kvdt, cuda).transpose(1, 2).contiguous().transpose(1, 2)
            for a in (k, v))
    lens = _th(lens, "int32", cuda)
    for window in (0, 100):
        got = decode_attention(q, k, v, lens, window=window, scale=1.0)
        again = decode_attention(q, k, v, lens, window=window, scale=1.0)
        torch.cuda.synchronize()
        _mma_gate(got, ref.decode_attention_ref(q, k, v, lens, window=window,
                                                scale=1.0), kvdt)
        assert float(got[0].float().abs().max()) == 0.0
        assert torch.equal(again, got)


@pytest.mark.cuda
def test_long_bf16_slab_with_many_splits_on_card(cuda):
    """A long bf16 slab (B 2, H 28, K 4, T 8,192, ragged lengths) split
    plan_splits ways (dozens a row): within 1e-2 of the plain version, a
    relaunch bit-identical."""
    B, H, K, T, d = 2, 28, 4, 8192, 128
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan_splits(B, K, T, sms) >= -(-T // SPLIT_CAP)
    g = torch.Generator(device=cuda).manual_seed(33)
    q = (torch.randn(B, H, d, generator=g, device=cuda) * d ** -0.5
         ).bfloat16()
    k, v = (torch.randn(B, T, K, d, generator=g, device=cuda).bfloat16()
            .transpose(1, 2) for _ in range(2))
    lens = torch.tensor([T, 5001], dtype=torch.int32, device=cuda)
    got = decode_attention(q, k, v, lens, scale=1.0)
    again = decode_attention(q, k, v, lens, scale=1.0)
    torch.cuda.synchronize()
    assert _err(got, ref.decode_attention_ref(q, k, v, lens, scale=1.0)) \
        <= TOL["bfloat16"]
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_long_slab_rows_keep_their_bits_when_rows_are_appended(cuda):
    """Where SPLIT_CAP sets a long slab's split count (B rows of T 8,192
    and more), appending rows of other lengths leaves the first rows'
    outputs bit for bit: their splits, and so their sums, are the same."""
    K, T, d, H = 4, 8192, 128, 28
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n_cap = -(-T // SPLIT_CAP)
    B = max(2, -(-2 * sms // (K * n_cap)))
    assert plan_splits(B, K, T, sms) == plan_splits(B + 3, K, T, sms) \
        == n_cap
    g = torch.Generator(device=cuda).manual_seed(34)
    q = (torch.randn(B + 3, H, d, generator=g, device=cuda) * d ** -0.5
         ).bfloat16()
    k, v = (torch.randn(B + 3, T, K, d, generator=g, device=cuda)
            .bfloat16().transpose(1, 2) for _ in range(2))
    lens = torch.randint(1, T + 1, (B + 3,), generator=g, device=cuda,
                         dtype=torch.int32)
    got = decode_attention(q[:B], k[:B], v[:B], lens[:B], scale=1.0)
    grown = decode_attention(q, k, v, lens, scale=1.0)
    torch.cuda.synchronize()
    assert torch.equal(grown[:B], got)


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
    """Tiny f32 configs whose head dim the decode kernels take (64); the
    MoE one is DeepSeekMoE's (a dense prefix layer, 16 stored experts) at
    its G = 1."""
    kw = dict(vocab_size=tok.VOCAB_SIZE, d_model=128, n_heads=4,
              n_kv_heads=2, head_dim=64, d_ff=256)
    if family == "dense":
        return get_config("qwen3-8b").reduced(name="tiny-graph-dense", **kw)
    if family == "moe":
        return get_config("deepseek-moe-16b").reduced(
            name="tiny-graph-moe", **dict(kw, n_kv_heads=4))
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
@pytest.mark.parametrize("family", ["dense", "moe", "hybrid"])
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
@pytest.mark.parametrize("family", ["dense", "moe", "hybrid"])
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
@pytest.mark.parametrize("family", ["dense", "moe", "hybrid"])
def test_graph_launch_counters_count_replays_on_card(cuda, family):
    cfg = _graph_cfg(family)
    kernel = (decode_attention if family == "hybrid"
              else paged_decode_attention)
    before = kernel.launches
    s0 = engine_mod.graph_cache_stats()
    _, eng = _graph_serve(cfg, _graph_params(cfg, 0, cuda), horizon=8,
                          temperature=0.0, graphs=True)
    s1 = engine_mod.graph_cache_stats()
    assert s1["replays"] > s0["replays"] and s1["captures"] > s0["captures"]
    assert kernel.launches - before == \
        cfg.n_layers * eng.horizon * eng.n_decode_dispatches


# --------------------------- the MoE layer on the card --------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_bit_repeatable_on_card(cuda, dtype):
    """DeepSeekMoE's layer (reduced to d 64, 8 experts stored as 16) on
    T = 1100 tokens with a shared offset, so that some experts overflow
    their capacity: two launches give the same bits (the combine sums each
    token's k slots in a fixed order, no atomics), the drop set equals the
    CPU's on the same f32 inputs, and the f32 output is within 1e-5 of
    the CPU's (bf16: 2e-2, the inputs and weights rounded)."""
    cfg = get_config("deepseek-moe-16b").reduced(dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    stack = init_params(cfg, gen, "cpu")["groups"]["sub0"]["mlp"]
    cpu_p = _tree_map(stack, lambda t: t[0])
    rs = np.random.RandomState(3)
    x = (rs.randn(4, 275, cfg.d_model) + rs.randn(cfg.d_model)) \
        .astype(np.float32)
    xc = torch.from_numpy(x).to(getattr(torch, dtype))
    p = _tree_map(cpu_p, lambda t: t.to(cuda))
    out, aux = moe.moe_layer(p, xc.to(cuda), cfg)
    again, aux2 = moe.moe_layer(p, xc.to(cuda), cfg)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(aux, aux2)
    T, k, Ep = 1100, cfg.top_k, cfg.n_experts_padded
    C = moe._capacity(T, cfg.n_experts, k, cfg.capacity_factor)
    xf = xc.float().reshape(T, -1)
    _, ids_c, _ = moe._route(xf, cpu_p["router"], k, Ep)
    _, ids_g, _ = moe._route(xf.to(cuda), p["router"], k, Ep)
    slot_c = moe._slots(ids_c, Ep, C)
    assert (slot_c == Ep * C).any()                  # entries were dropped
    assert torch.equal(moe._slots(ids_g, Ep, C).cpu(), slot_c)
    if dtype == "float32":
        want, want_aux = moe.moe_layer(cpu_p, xc, cfg)
        assert _err(out, want) <= 1e-5
        assert abs(float(aux) - float(want_aux)) <= 1e-5


# ---- the gemma family: d = 256 (gemma3) and G = 2 with a softcap (gemma2) ---- #
GEMMA_DECODE = [(4, 8, 4, 16, 8, 256, 0.0), (4, 32, 16, 16, 8, 128, 50.0)]
GEMMA_PREFILL = [(4, 96, 8, 4, 16, 6, 256, 0.0), (4, 1, 8, 4, 16, 6, 256, 0.0),
                 (3, 130, 8, 4, 16, 8, 256, 0.0),
                 (4, 200, 32, 16, 16, 6, 128, 50.0)]
GEMMA_SLAB = [(5, 8, 4, 1024, 256, 0, 0.0), (3, 8, 4, 300, 256, 100, 0.0),
              (4, 32, 16, 512, 128, 0, 50.0)]
GEMMA_FLASH = [(2, 8, 4, 300, 256, True, 128, 0.0),
               (1, 8, 4, 1, 256, True, 0, 0.0),
               (1, 4, 2, 77, 256, False, 0, 20.0),
               (2, 4, 2, 200, 256, True, 64, 30.0),
               (1, 32, 16, 300, 128, True, 128, 50.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", KV_DTYPES)
@pytest.mark.parametrize("case", GEMMA_DECODE)
def test_gemma_decode_kernel_matches_plain_on_card(cuda, case, qdt, kvdt):
    test_decode_kernel_matches_plain_on_card(cuda, *case, qdt, kvdt)
    test_decode_split_is_fixed_in_position_space_on_card(cuda, *case, qdt,
                                                         kvdt)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", KV_DTYPES)
@pytest.mark.parametrize("case", GEMMA_PREFILL)
def test_gemma_prefill_kernel_matches_plain_on_card(cuda, case, qdt, kvdt):
    test_prefill_kernel_matches_plain_on_card(cuda, *case, qdt, kvdt)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", KV_DTYPES)
@pytest.mark.parametrize("case", GEMMA_SLAB)
def test_gemma_slab_decode_kernel_matches_plain_on_card(cuda, case, qdt,
                                                        kvdt):
    test_slab_decode_kernel_matches_plain_on_card(cuda, *case, qdt, kvdt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GEMMA_FLASH)
def test_gemma_flash_kernel_matches_plain_on_card(cuda, case, dtype):
    test_flash_kernel_matches_plain_on_card(cuda, *case, dtype)


@pytest.mark.cuda
def test_gemma_graph_horizon_on_card(cuda):
    """A tiny gemma3 at d = 256 (local layers on rings, global ones on the
    pools, a suffix): replayed tokens and logprobs bit-equal to eager H=8
    and H=1; the paged decode counts global layers x H x horizons and
    ``decode_attention`` local layers x H x horizons, with replays."""
    cfg = get_config("gemma3-4b").reduced(
        name="tiny-graph-gemma", vocab_size=tok.VOCAB_SIZE, d_model=128,
        n_heads=4, n_kv_heads=2, head_dim=256, d_ff=256)
    params = _graph_params(cfg, 0, cuda)
    mixers = cfg.layer_mixers()
    before = (paged_decode_attention.launches, decode_attention.launches)
    got, eng = _graph_serve(cfg, params, horizon=8, temperature=0.0,
                            graphs=True)
    steps = eng.horizon * eng.n_decode_dispatches
    assert eng.graph_capture_s, "no horizon was captured"
    assert paged_decode_attention.launches - before[0] == \
        mixers.count("global") * steps
    assert decode_attention.launches - before[1] == \
        mixers.count("local") * steps
    eager8, _ = _graph_serve(cfg, params, horizon=8, temperature=0.0,
                             graphs=False)
    eager1, _ = _graph_serve(cfg, params, horizon=1, temperature=0.0,
                             graphs=False)
    assert got == eager8
    assert got == eager1


# ---- training the other families: hubert's d = 80, the scan's gradient ---- #
# flash at hubert-xlarge's d = 80: its train shape (bidirectional, H = K =
# 16), a ragged S, one position, and d = 80 causal with a window and a
# softcap (the kernel's other masks at this width)
HUBERT_FLASH = [(4, 16, 16, 1024, 80, False, 0, 0.0),
                (2, 4, 4, 77, 80, False, 0, 0.0),
                (1, 4, 4, 1, 80, False, 0, 0.0),
                (2, 8, 2, 300, 80, True, 64, 20.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", HUBERT_FLASH)
def test_hubert_flash_kernel_matches_plain_on_card(cuda, case, dtype):
    test_flash_kernel_matches_plain_on_card(cuda, *case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("use_state", [True, False])
@pytest.mark.parametrize("b,L,H,G,P,N,chunk", [(2, 150, 6, 2, 32, 16, 64),
                                               (1, 64, 4, 1, 64, 128, 64)])
def test_ssd_function_grads_match_plain_autograd_on_card(cuda, b, L, H, G,
                                                         P, N, chunk,
                                                         use_state):
    """``ops.ssd`` on CUDA under autograd: one kernel launch, its y and
    state within the kernel's f32 tolerance of the plain scan, and the
    gradients of every input (through the recomputed chunked scan) within
    1e-4 of each leaf's max |value| of autograd through the sequential
    plain scan on the same card (f32 sums in another order), with the
    final state's gradient and with the state unused (train mode)."""
    args = _ssd_inputs(b, L, H, G, P, N, seed=7)
    rs = np.random.RandomState(1)
    wy = torch.from_numpy(rs.randn(b, L, H, P).astype(np.float32)).to(cuda)
    ws = torch.from_numpy(rs.randn(b, H, P, N).astype(np.float32)).to(cuda)

    def grads(fn):
        leaves = [torch.from_numpy(a).to(cuda).requires_grad_(True)
                  for a in args]
        y, st = fn(*leaves)
        loss = (y * wy).sum() + ((st * ws).sum() if use_state else 0.0)
        loss.backward()
        return (y.detach(), st.detach()), [t.grad for t in leaves]

    before = ssd_scan.launches
    got_out, got = grads(lambda *a: ops.ssd(*a, chunk=chunk))
    assert ssd_scan.launches == before + 1
    want_out, want = grads(lambda *a: ref.ssd_scan_ref(*a))
    torch.cuda.synchronize()
    for g, w in zip(got_out, want_out):
        assert _rel(g, w) < SSD_TOL["float32"]
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-4


# ----------------- the (arch x shape) cells' kernel shapes --------------- #
# The inputs here are drawn on the card from seeded torch generators: numpy
# would spend seconds drawing the 524,288-position ones on the host.
CELL_FLASH = [(2, 28, 4, 32768, 128, True, 0),       # qwen2-7b prefill_32k
              (1, 25, 5, 524288, 64, True, 1024)]    # hymba long_500k
CELL_SSD = [(1, 524288, 24, 1, 64, 128, 64),         # mamba2-130m long_500k
            (1, 524288, 50, 1, 64, 16, 64)]          # hymba long_500k


def _flash_rows_plain(q, k, v, i0, i1, causal, window):
    """The plain attention of query rows i0..i1-1 against every key they
    see, f32 (q [B, H, S, d] unscaled): the whole [S, S] would not fit."""
    B, H, S, d = q.shape
    G = H // k.shape[1]
    j0 = max(0, i0 - window + 1) if window else 0
    j1 = i1 if causal else S
    s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, i0:i1].float() * d ** -0.5,
                     k[:, :, j0:j1].float().repeat_interleave(G, dim=1))
    qi = torch.arange(i0, i1, device=q.device)[:, None]
    kj = torch.arange(j0, j1, device=q.device)[None]
    keep = torch.ones_like(qi - kj, dtype=torch.bool)
    if causal:
        keep &= kj <= qi
    if window:
        keep &= (qi - kj) < window
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v[:, :, j0:j1].float().repeat_interleave(G, dim=1))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CELL_FLASH)
def test_flash_at_cell_shapes_on_card(cuda, case):
    """bf16 flash at the cells' lengths (S = 32,768 with G = 7; S =
    524,288 with a window of 1024, d = 64), head-major views of [B, S,
    heads, d]: the first and last 128 query rows within the bf16 gate of
    the plain attention of those rows, a second launch bit-identical."""
    B, H, K, S, d, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(25)
    q, k, v = (torch.randn(B, S, n, d, generator=g, device=cuda)
               .bfloat16().transpose(1, 2) for n in (H, K, K))
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal,
                                            window=window))
    tol = FLASH_TOL["bfloat16"]
    for i0 in (0, S - 128):
        want = _flash_rows_plain(q, k, v, i0, i0 + 128, causal, window)
        got = out[:, :, i0:i0 + 128].float()
        assert bool(((got - want).abs() <= tol * (1 + want.abs())).all())


@pytest.mark.cuda
def test_slab_decode_at_decode_32k_on_card(cuda):
    """decode_attention on decode_32k's 8-row bf16 slab of 32,896 slots
    (q pre-scaled, scale 1.0, lengths 32,769-32,772) within 2e-2 of its
    plain version, whole."""
    B, H, K, T, d = 8, 28, 4, 32896, 128
    g = torch.Generator(device=cuda).manual_seed(26)
    q = (torch.randn(B, H, d, generator=g, device=cuda) * d ** -0.5
         ).bfloat16()
    k, v = (torch.randn(B, T, K, d, generator=g, device=cuda).bfloat16()
            .transpose(1, 2) for _ in range(2))
    lens = torch.tensor([32769, 32770, 32771, 32772] * 2, dtype=torch.int32,
                        device=cuda)
    out = decode_attention(q, k, v, lens, scale=1.0)
    want = ref.decode_attention_ref(q, k, v, lens, scale=1.0)
    assert _err(out, want) <= FLASH_TOL["bfloat16"] * (
        1 + float(want.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CELL_SSD)
def test_ssd_at_long_500k_on_card(cuda, case):
    """The scan over 524,288 positions (8,192 chunks) in f32 against the
    plain chunked scan run in segments of 32,768 carrying the state (the
    sequential plain scan would take 524,288 steps): y and the final state
    within a relative 2e-5."""
    from repro_torch.models.ssm import ssd_chunked
    b, L, H, G, P, N, chunk = case
    g = torch.Generator(device=cuda).manual_seed(27)
    x = torch.randn(b, L, H, P, generator=g, device=cuda)
    dt = torch.nn.functional.softplus(torch.randn(b, L, H, generator=g,
                                                  device=cuda))
    A = -torch.exp(torch.randn(H, generator=g, device=cuda) * 0.3)
    Bm, Cm = (torch.randn(b, L, G, N, generator=g, device=cuda)
              for _ in range(2))
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    state = torch.zeros(b, H, P, N, device=cuda)
    rep, seg = H // G, 32768
    for s0 in range(0, L, seg):
        sl = slice(s0, s0 + seg)
        ys, ss = ssd_chunked(x[:, sl], dt[:, sl], A, Bm[:, sl], Cm[:, sl],
                             chunk=chunk)
        cum = torch.cumsum(dt[:, sl] * A, dim=1)
        ys += torch.einsum("blhn,bhpn->blhp",
                           Cm[:, sl].repeat_interleave(rep, dim=2),
                           state) * torch.exp(cum)[..., None]
        state = ss + torch.exp(cum[:, -1])[:, :, None, None] * state
        assert _rel(y[:, sl], ys) < SSD_TOL["float32"]
    assert _rel(st, state) < SSD_TOL["float32"]


# ---------------- prefill entries and the cells' serve step ---------------- #
def _cache_items(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _cache_items(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _snapshot(cache):
    return {k: v.clone() for k, v in _cache_items(cache)}


def _equal_but_garbage(cache, snap):
    """Every leaf of ``cache`` equal to ``snap``'s, the pools' garbage page
    (page 0, where padding rows write in no fixed order) left out."""
    for k, v in _cache_items(cache):
        a, b = (v[:, 1:], snap[k][:, 1:]) if "pages" in k else (v, snap[k])
        assert torch.equal(a, b), k


def _prefill_rounds(eng, prompts, rounds: int, on_last=None):
    """``rounds`` times: admit ``prompts`` as singles, one step (their
    one prefill dispatch), then drop them.  ``on_last(entry)`` runs
    before the last round's step.  Returns each round's first-token
    events [(rid, token, logprob)]."""
    out = []
    for r in range(rounds):
        rids = [10 * r + i for i in range(len(prompts))]
        for rid, p in zip(rids, prompts):
            eng.add_request(rid, p, request_key(6, rid), len(p) + 8, len(p))
        if r == rounds - 1 and on_last is not None:
            on_last()
        out.append([(e.req_id % 10, e.token, e.logprob) for e in eng.step()])
        assert eng.n_prefill_dispatches == r + 1
        for rid in rids:
            eng.drop_request(rid)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dense", "moe", "hybrid"])
def test_prefill_replay_bit_equal_to_eager_body_on_card(cuda, family):
    """Three prefill dispatches at one key (the eager warm-up, the
    capture, a replay): the replay's logits, pages (the garbage page
    aside), per-slot rows and ``pos`` are bit-equal to the eager body run
    again from the state before it, and its first tokens and logprobs
    equal a ``cuda_graphs=False`` engine's in every round."""
    cfg = _graph_cfg(family)
    params = _graph_params(cfg, 0, cuda)
    prompts = _graph_prompts(7)

    def mk(graphs):
        return InferenceEngine(cfg, params, max_batch=4, slab_len=64,
                               page_size=16, temperature=1.0, horizon=4,
                               device="cuda", cuda_graphs=graphs)
    eng, held = mk(True), {}
    s0 = engine_mod.graph_cache_stats()
    got = _prefill_rounds(eng, prompts, 3,
                          on_last=lambda: held.update(_snapshot(eng.cache)))
    s1 = engine_mod.graph_cache_stats()
    assert s1["prefill_captures"] - s0["prefill_captures"] == 1
    assert s1["prefill_replays"] - s0["prefill_replays"] == 2
    (entry,) = eng._prefill_graphs.values()
    assert entry.graph is not None and len(eng.prefill_capture_s) == 1
    torch.cuda.synchronize()
    replayed, logits = _snapshot(eng.cache), entry.out.clone()
    for k, v in _cache_items(eng.cache):
        v.copy_(held[k])
    again = eng._prefill_body(entry)
    torch.cuda.synchronize()
    assert torch.equal(again, logits)
    _equal_but_garbage(eng.cache, replayed)
    assert got == _prefill_rounds(mk(False), prompts, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_prefill_graph_launch_counters_count_replays_on_card(cuda, family):
    """The prefill kernel's launches (the paged prefill for a global
    layer, the scan for the hybrid one) equal layers x dispatches with
    replays among them."""
    cfg = _graph_cfg(family)
    kernel = ssd_scan if family == "hybrid" else paged_prefill_attention
    eng = InferenceEngine(cfg, _graph_params(cfg, 0, cuda), max_batch=4,
                          slab_len=64, page_size=16, device="cuda")
    kinds = ("mamba", "hybrid") if family == "hybrid" else ("global",)
    layers = sum(m in kinds for m in cfg.layer_mixers())
    before = kernel.launches
    _prefill_rounds(eng, _graph_prompts(7), 4)
    assert layers and kernel.launches - before == layers * 4


@pytest.mark.cuda
def test_pool_growth_frees_the_prefill_graphs_first_on_card(cuda,
                                                             monkeypatch):
    """The pool grows while the engine holds a captured prefill entry: the
    entry is dropped and its graph pool returned to the device before the
    larger KV pool is allocated (the device's reserved bytes then are at
    most those before less the graph pool's), and the first tokens and
    decodes after it equal an eager engine's grown at the same point."""
    cfg = _graph_cfg("dense")
    params = _graph_params(cfg, 0, cuda)
    prompts = _graph_prompts(7)
    grow, at_alloc = engine_mod.kvc.grow_pool, []

    def spy(cache, n):
        torch.cuda.synchronize()
        at_alloc.append((len(eng._prefill_graphs) + len(eng._graphs),
                         torch.cuda.memory_reserved()))
        return grow(cache, n)
    monkeypatch.setattr(engine_mod.kvc, "grow_pool", spy)
    outs = []
    for graphs in (True, False):
        eng = InferenceEngine(cfg, params, max_batch=4, slab_len=64,
                              page_size=16, temperature=1.0, horizon=4,
                              device="cuda", cuda_graphs=graphs)
        out = _prefill_rounds(eng, prompts, 3)
        if graphs:
            (entry,) = eng._prefill_graphs.values()
            pool = eng.graph_pool_bytes()
            assert entry.graph is not None and pool > 0
            del entry
            torch.cuda.synchronize()
            reserved = torch.cuda.memory_reserved()
        pages = eng.alloc.num_pages
        eng._grow_pool()
        assert eng.alloc.num_pages == 2 * pages
        if graphs:
            assert at_alloc[-1][0] == 0 and not eng._prefill_graphs
            assert at_alloc[-1][1] <= reserved - pool, (at_alloc, reserved,
                                                        pool)
        for rid, p in enumerate(prompts):
            eng.add_request(100 + rid, p, request_key(6, 100 + rid),
                            len(p) + 12, len(p))
        while eng.active_request_ids():
            out.append([(e.req_id, e.token, e.logprob) for e in eng.step()])
        outs.append(out)
    assert outs[0] == outs[1]


def _cell_cache(cfg, params, cuda, rows=2, length=40):
    from repro_torch.launch.steps import build_prefill_step
    x = torch.from_numpy(np.random.RandomState(8).randint(
        3, cfg.vocab_size, (rows, length)).astype(np.int32)).to(cuda)
    return build_prefill_step(cfg, slab_len=length + 8)(params,
                                                        {"tokens": x})


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-130m", "hymba-1.5b"])
def test_captured_serve_step_bit_equal_to_eager_on_card(cuda, arch):
    """Five serve steps on a reduced cell's slab (bf16, heads of 64, as
    the kernels take them): ``CapturedServeStep``
    (the warm-up, the capture, three replays) against ``build_serve_step``
    on a copy of the same cache: next tokens and logits bit-equal, every
    cache leaf equal after each step, ``pos`` advanced in place, one
    capture and four replay-served calls."""
    from repro_torch.launch.steps import CapturedServeStep, build_serve_step
    kw = {} if arch == "mamba2-130m" else dict(
        d_model=128, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=256)
    cfg = get_config(arch).reduced(dtype="bfloat16", **kw)
    params = _graph_params(cfg, 2, cuda)
    nxt, cache = _cell_cache(cfg, params, cuda)
    eager_cache = _clone_tree(cache)
    eager = build_serve_step(cfg, return_logits=True)
    step = CapturedServeStep(cfg, return_logits=True)
    pos = cache["pos"]
    t_e = t_c = nxt
    for i in range(5):
        t_e, eager_cache, lg_e = eager(params, eager_cache, t_e)
        t_c, out_cache, lg_c = step(params, cache, t_c)
        torch.cuda.synchronize()
        assert out_cache is cache and cache["pos"] is pos
        assert torch.equal(t_c, t_e) and torch.equal(lg_c, lg_e), i
        want = dict(_cache_items(eager_cache))
        for k, v in _cache_items(cache):
            assert torch.equal(v, want[k]), (i, k)
    assert step.captures == 1 and step.replays == 4


# ------------------- the rank-local kernels of the sharded trainer ------- #
# (mesh shape, q / x heads, kv heads or SSM groups): heads sharded over
# "model" where they divide it; K = 1 at model 2 replicates them (the work
# repeats on each rank); data 2 shards the batch
RANK_LOCAL_CASES = (("attention", (1, 2), 32, 8), ("attention", (1, 2), 8, 1),
                    ("attention", (2, 1), 32, 8), ("ssd", (1, 2), 24, 1))


def _rank_local_worker(rank, address, kind, shape, H, K):
    """Rank ``rank`` of 2 gloo ranks on cuda:0: the rank-local
    ``ops.attention_bshd`` (forward and backward) or ``ops.ssd`` on
    DTensors of a (data, model) mesh against the single call on the whole
    tensors (rank 0 and 1 both check; an assertion fails the spawn)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import init_rank
    init_rank(rank, 2, "gloo", torch.device("cuda"), address)
    mesh = make_local_mesh(*shape, "cuda")
    rs = np.random.RandomState(11)
    data = shape[0] > 1
    # the batch (dim 0) over data, or the heads (dim 2) over model; a dim
    # that the model axis does not divide stays whole
    rep = Replicate()
    lead = [Shard(0), rep] if data else [rep, Shard(2)]
    whole = [Shard(0), rep] if data else [rep, rep]

    def put(a, placements):
        return distribute_tensor(a, mesh, placements, src_data_rank=None)
    if kind == "attention":
        B, S, d = 2, 384, 128
        q, k, v = (torch.from_numpy(rs.randn(B, S, n, d).astype(np.float32))
                   .to("cuda", torch.bfloat16) for n in (H, K, K))
        g = torch.from_numpy(rs.randn(B, S, H, d).astype(np.float32)) \
            .to("cuda", torch.bfloat16)
        leaves = [t.requires_grad_(True) for t in (q, k, v)]
        want = ops.attention_bshd(*leaves, causal=True)
        want_g = torch.autograd.grad(want, leaves, g)
        kv = lead if K % shape[1] == 0 else whole
        dq, dk, dv = (put(t.detach(), p).requires_grad_(True) for t, p in
                      ((q, lead), (k, kv), (v, kv)))
        got = ops.attention_bshd(dq, dk, dv, causal=True)
        got_g = torch.autograd.grad(got, [dq, dk, dv], put(g, lead))
        outs = [(got, want)] + list(zip(got_g, want_g))
    else:
        b, L, P, N = 2, 512, 64, 128
        x = torch.from_numpy(rs.randn(b, L, H, P).astype(np.float32)).cuda()
        dt = torch.from_numpy(rs.rand(b, L, H).astype(np.float32) * 0.1) \
            .cuda()
        A = -torch.from_numpy(rs.rand(H).astype(np.float32) + 0.5).cuda()
        Bm, Cm = (torch.from_numpy(rs.randn(b, L, K, N).astype(np.float32))
                  .cuda() for _ in range(2))
        want = ops.ssd(x, dt, A, Bm, Cm)
        # C as a plain tensor: taken as replicated
        got = ops.ssd(put(x, lead), put(dt, lead),
                      put(A, [rep, rep] if data else [rep, Shard(0)]),
                      put(Bm, whole), Cm)
        outs = list(zip(got, want))
    ok = [torch.equal(a.full_tensor(), w) for a, w in outs]
    dist.destroy_process_group()
    assert all(ok), (kind, shape, H, K, ok)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,H,K", RANK_LOCAL_CASES)
def test_rank_local_kernels_on_two_gloo_ranks_on_card(cuda, kind, shape,
                                                      H, K):
    """The sharded trainer's attention and scan on DTensors over 2 gloo
    ranks sharing the card (``kernels.ops._rank_local``): heads sharded
    (GQA blocks aligned: rank r's q heads read rank r's kv heads),
    replicated (K = 1 does not divide 2) or the batch sharded; outputs (and
    the attention's gradients through the recomputed plain backward) equal
    bit for bit to the single call on the whole tensors, since every (row,
    head) is computed alone."""
    import torch.multiprocessing as mp

    from repro_torch.launch.train import free_port
    mp.start_processes(_rank_local_worker, nprocs=2, join=True,
                       start_method="spawn",
                       args=(f"tcp://localhost:{free_port()}", kind, shape,
                             H, K))


# ------------------- the graphs across weight swaps ------------------------ #
def _swap_rounds(cfg, versions, graphs):
    """Eight rounds, each two prompts admitted (one prefill dispatch at
    one key) and served to their 16 new tokens in three steps, with
    ``versions[k]`` swapped in after rounds 1, 3 and 5.  Returns (events
    [(rid, token, logprob, version)], engine, {k: (captures, {key: (the
    entry, its graph)}) just after swap k})."""
    eng = InferenceEngine(cfg, versions[0], max_batch=4, slab_len=128,
                          page_size=16, temperature=1.0, horizon=8,
                          device="cuda", cuda_graphs=graphs)
    prompts = _graph_prompts(5)[:2]
    out, at = [], {}
    for r in range(8):
        for i, p in enumerate(prompts):
            rid = 10 * r + i
            eng.add_request(rid, p, request_key(9, rid), len(p) + 16, len(p))
        for _ in range(3):
            out += [(e.req_id, e.token, e.logprob, e.weight_version)
                    for e in eng.step()]
        assert not eng.active_request_ids()
        if r in (1, 3, 5):
            k = (r + 1) // 2
            eng.swap_weights(versions[k], k)
            at[k] = (len(eng.graph_capture_s) + len(eng.prefill_capture_s),
                     {key: (e, e.graph) for key, e in
                      {**eng._graphs, **eng._prefill_graphs}.items()})
    return out, eng, at


@pytest.mark.cuda
def test_graphs_outlive_weight_swaps_at_qwen3_8b_width_on_card(cuda):
    """Qwen3-8B at full width, 2 layers, swapped three times: the first
    swap drops the entries, and from the second on the engine captures
    nothing new and replays the same graphs (the version copied into its
    own leaves); its tokens and logprobs are bit-equal to an eager
    engine's given the same swaps, and no version passed in changes."""
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=2,
                              name="qwen3-8b-swap-graphs")
    versions = [_graph_params(cfg, s, cuda) for s in range(4)]
    held = [_snapshot(v) for v in versions]
    s0 = engine_mod.graph_cache_stats()
    got, eng, at = _swap_rounds(cfg, versions, True)
    s1 = engine_mod.graph_cache_stats()
    assert eng.graph_counts["swap_invalidations"] == 1
    assert s1["invalidations"] - s0["invalidations"] == 1
    assert at[2][0] > 0 and at[2][1]
    for k in (2, 3):
        assert at[k][0] == at[2][0]
        assert at[k][1].keys() == at[2][1].keys()
        assert all(e is e2 and g is g2 and g is not None
                   for (e, g), (e2, g2) in zip(at[2][1].values(),
                                               at[k][1].values()))
    assert len(eng.graph_capture_s) + len(eng.prefill_capture_s) == \
        at[2][0]
    assert eng.graph_counts["recaptures"] == 0
    assert eng.graph_counts["prefill_replays"] >= 4
    want, _, _ = _swap_rounds(cfg, versions, False)
    assert got == want
    assert {v for *_, v in got} == {0, 1, 2, 3}
    for v, h in zip(versions, held):
        assert all(torch.equal(t, h[k]) for k, t in _cache_items(v))


def _scaled_tree(tree, f):
    return {k: _scaled_tree(v, f) if isinstance(v, dict) else v * f
            for k, v in tree.items()}


def _delta_rounds(cfg, v0, v1, graphs, manifest=None, store=None,
                  tree=None):
    """Six rounds as ``_swap_rounds``'s: v1 swapped in after round 1 (the
    engine's own leaves from then on), then after round 3 a delta-int8
    version installed: decoded from ``manifest`` onto the engine's leaves
    (``tree`` None) or ``tree`` given.  Returns (events, engine, the
    installed tree, {"before"/"after": graph counts and captures at the
    install})."""
    eng = InferenceEngine(cfg, v0, max_batch=4, slab_len=128, page_size=16,
                          temperature=1.0, horizon=8, device="cuda",
                          cuda_graphs=graphs)
    prompts = _graph_prompts(5)[:2]
    out, at = [], {}
    for r in range(6):
        for i, p in enumerate(prompts):
            rid = 10 * r + i
            eng.add_request(rid, p, request_key(9, rid), len(p) + 16, len(p))
        for _ in range(3):
            out += [(e.req_id, e.token, e.logprob, e.weight_version)
                    for e in eng.step()]
        if r == 1:
            eng.swap_weights(v1, 1)
        if r == 3:
            assert eng._owns_params
            if tree is None:
                chunks = {c.digest: store.fetch(c.digest)
                          for c in manifest.chunks}
                tree = store.assemble(manifest, chunks, like=eng.params,
                                      base_params=eng.params)
            at["before"] = (dict(eng.graph_counts), len(eng.graph_capture_s))
            eng.swap_weights(tree, 3)
    at["after"] = (dict(eng.graph_counts), len(eng.graph_capture_s))
    return out, eng, tree, at


@pytest.mark.cuda
def test_delta_int8_onto_owned_leaves_replays_at_qwen3_8b_width_on_card(
        cuda):
    """Qwen3-8B at full width (bf16), 2 layers: after a swap has given the
    engine leaves of its own, a delta-int8 v3 (v1 x 1.01, base v1) is
    decoded by ``fused_dequant`` (one launch a leaf, bf16 base) onto those
    leaves and swapped in place: no capture and no invalidation after it,
    the captured horizon replayed, every token and logprob bit-equal to an
    eager engine given the same decoded tree, and each leaf within the
    codec's bound of v3 (scale / 2 plus the bf16 cast's half ulp)."""
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=2,
                              name="qwen3-8b-delta-graphs")
    v0, v1 = (_graph_params(cfg, s, cuda) for s in (0, 1))
    v3 = _scaled_tree(v1, 1.01)
    store = ChunkStore(chunk_bytes=1 << 20)
    store.publish(1, v1)
    store.publish(3, v3)
    m = store.manifest(3, "delta-int8", base_version=1)
    coded = sum(s.codec == "delta-int8" for s in m.leaves)
    assert m.codec == "delta-int8" and coded == len(m.leaves)
    n0 = fused_dequant.launches
    got, eng, tree, at = _delta_rounds(cfg, v0, v1, True, m, store)
    assert fused_dequant.launches - n0 == coded
    (before, caps0), (after, caps1) = at["before"], at["after"]
    assert before["swap_invalidations"] == after["swap_invalidations"] == 1
    assert caps1 == caps0 > 0 and after["recaptures"] == 0
    assert after["replays"] > before["replays"]
    for (k, a), (_, b) in zip(_cache_items(eng.params), _cache_items(tree)):
        assert torch.equal(a, b), k
    want, _, _, _ = _delta_rounds(cfg, v0, v1, False, tree=tree)
    assert got == want
    assert {v for *_, v in got} == {0, 1, 3}
    base, target = dict(_cache_items(v1)), dict(_cache_items(v3))
    for k, a in _cache_items(tree):
        rows = (lambda t: t.float().reshape(-1, t.shape[-1]) if t.dim() > 1
                else t.float().reshape(-1, 1))
        d = rows(target[k]) - rows(base[k])
        scale = d.abs().amax(dim=0) / 127.0 + 1e-12
        err = (rows(a) - rows(target[k])).abs()
        bound = scale / 2 + (2.0 ** -8 + 2.0 ** -22) * torch.maximum(
            rows(a).abs(), rows(target[k]).abs())
        assert bool((err <= bound).all()), k


# ---------------------------- the backward kernels ------------------------ #
# each gradient's max |got - want| over its max |want|: bf16 gradients are
# rounded once from f32 sums and the flash kernel rounds P and dS to bf16
# for its products; f32 flash (CUDA cores) and the 3xTF32 scan sum in
# another order (as test_ssd_function_grads_match_plain_autograd_on_card
# holds the scan's gradients)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (B, H, K, S, d, causal, window, cap): a few shapes per feature (GQA,
# window, MQA with a softcap, bidirectional, bidirectional with a window,
# ragged S, G = 5 and 7, every head dim, one position)
FLASH_BWD_CASES = [(2, 4, 2, 256, 64, True, 0, 0.0),
                   (1, 4, 4, 256, 64, True, 64, 0.0),
                   (2, 2, 1, 128, 32, True, 0, 50.0),
                   (1, 8, 2, 256, 128, False, 0, 0.0),
                   (1, 6, 3, 301, 64, False, 100, 25.0),
                   (2, 4, 2, 200, 64, True, 48, 20.0),
                   (2, 10, 2, 259, 64, True, 130, 0.0),
                   (1, 7, 1, 190, 128, True, 0, 0.0),
                   (2, 4, 4, 77, 80, False, 0, 0.0),
                   (1, 4, 2, 150, 256, True, 64, 30.0),
                   (1, 4, 4, 1, 128, True, 0, 0.0)]


def _grad_err(got, want):
    """max |got - want| over max |want|, floored at 1e-2: at S = 1 the
    softmax of one key is constant, so dq and dk are exactly zero, and the
    kernel's dP - D there is f32 rounding of two sums taken in other
    orders (their magnitude ~1e-5)."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-2)


def _flash_plain_grads(args, do, opts):
    leaves = [a.detach().requires_grad_(True) for a in args]
    out = ref.flash_attention_ref(*leaves, **opts)
    return torch.autograd.grad(out, leaves, do)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,d,causal,window,cap", FLASH_BWD_CASES)
def test_flash_backward_kernel_matches_plain_on_card(cuda, B, H, K, S, d,
                                                     causal, window, cap,
                                                     dtype):
    """``flash_attention_backward`` against autograd through the plain
    version on the same inputs, head-major and as views of the model's
    [B, S, heads, d] layout (each gradient in its input's memory order),
    within BWD_TOL of each gradient's max |want|; a second launch
    bit-identical."""
    opts = dict(causal=causal, window=window, cap=cap)
    args = [_th(a, dtype, cuda) for a in _flash_inputs(B, H, K, S, d, seed=3)]
    do = _th(np.random.RandomState(4).randn(B, H, S, d).astype(np.float32),
             dtype, cuda)
    out = ref.flash_attention_ref(*args, **opts)
    want = _flash_plain_grads(args, do, opts)
    got = flash_attention_backward(*args, out, do, **opts)
    again = flash_attention_backward(*args, out, do, **opts)
    bshd = [a.transpose(1, 2).contiguous().transpose(1, 2)
            for a in args + [out, do]]
    got2 = flash_attention_backward(*bshd, **opts)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for g, g2, w, a in zip(got, got2, want, args):
        assert g.dtype == a.dtype and g.shape == a.shape
        assert g2.transpose(1, 2).is_contiguous()
        assert _grad_err(g, w) <= BWD_TOL[dtype]
        assert torch.equal(g, g2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_function_backward_runs_the_kernel_on_card(cuda, dtype):
    """``ops.attention_bshd`` under autograd on the card: one forward and
    one backward launch, no plain backward, gradients within BWD_TOL of
    autograd through the plain attention."""
    B, H, K, S, d = 2, 8, 2, 300, 128
    opts = dict(causal=True, window=0, cap=0.0)
    args = [_th(a, dtype, cuda).transpose(1, 2).contiguous()
            for a in _flash_inputs(B, H, K, S, d, seed=5)]
    w = _th(np.random.RandomState(6).randn(B, S, H, d).astype(np.float32),
            dtype, cuda)
    leaves = [a.requires_grad_(True) for a in args]
    f0, b0 = flash_attention.launches, flash_attention_backward.launches
    got = torch.autograd.grad(ops.attention_bshd(*leaves, **opts), leaves, w)
    assert flash_attention.launches == f0 + 1
    assert flash_attention_backward.launches == b0 + 1
    plain = [a.detach().requires_grad_(True) for a in args]
    out = ref.flash_attention_ref(*(a.transpose(1, 2) for a in plain),
                                  **opts).transpose(1, 2)
    want = torch.autograd.grad(out, plain, w)
    for g, wt in zip(got, want):
        assert _rel(g, wt) <= BWD_TOL[dtype]


# (b, L, H, G, P, N, chunk): both families' geometries cut short, G > 1, a
# ragged L, L below one chunk, a shorter chunk, Hymba's 50 heads of one
# group (head blocks of 8: the last one partial)
SSD_BWD_CASES = [(2, 150, 6, 2, 32, 16, 64), (1, 64, 4, 1, 64, 128, 64),
                 (1, 75, 4, 2, 16, 16, 32), (1, 20, 4, 1, 8, 8, 32),
                 (1, 256, 50, 1, 64, 16, 64), (2, 130, 24, 1, 64, 128, 64)]


def _ssd_plain_grads(args, gy, gs, chunk):
    from repro_torch.models.ssm import ssd_chunked
    leaves = [a.detach().requires_grad_(True) for a in args]
    outs = [(o, g) for o, g in zip(ssd_chunked(*leaves, chunk=chunk),
                                   (gy, gs)) if g is not None]
    return torch.autograd.grad([o for o, _ in outs], leaves,
                               [g for _, g in outs])


@pytest.mark.cuda
@pytest.mark.parametrize("use_state", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,L,H,G,P,N,chunk", SSD_BWD_CASES)
def test_ssd_backward_kernel_matches_plain_on_card(cuda, b, L, H, G, P, N,
                                                   chunk, dtype, use_state):
    """``ssd_scan_backward`` against autograd through the plain chunked
    scan on the same inputs, with the final state's gradient and with y's
    alone: each gradient in its input's dtype, within BWD_TOL of its max
    |want|; a second launch bit-identical."""
    x, dt, A, B, C = _ssd_inputs(b, L, H, G, P, N, seed=9)
    args = [_th(a, dtype, cuda) for a in (x, dt)] + [_th(A, "float32", cuda)] \
        + [_th(a, dtype, cuda) for a in (B, C)]
    rs = np.random.RandomState(10)
    gy = torch.from_numpy(rs.randn(b, L, H, P).astype(np.float32)).to(cuda)
    gs = torch.from_numpy(rs.randn(b, H, P, N).astype(np.float32)).to(cuda) \
        if use_state else None
    want = _ssd_plain_grads(args, gy, gs, chunk)
    got = ssd_scan_backward(*args, gy, gs, chunk=chunk)
    again = ssd_scan_backward(*args, gy, gs, chunk=chunk)
    torch.cuda.synchronize()
    for g, a2, w, a in zip(got, again, want, args):
        assert torch.equal(g, a2)
        assert g.dtype == a.dtype and g.shape == a.shape
        assert _rel(g, w) <= BWD_TOL[dtype]


@pytest.mark.cuda
def test_ssd_backward_kernel_on_strided_conv_slices_on_card(cuda):
    """x, B and C as the model passes them, strided slices of one conv
    output, and dy a transposed view: the same gradients as on dense
    copies, bit for bit."""
    b, L, H, G, P, N, chunk = 2, 200, 6, 2, 32, 16, 64
    rs = np.random.RandomState(12)
    xbc = torch.from_numpy(rs.randn(b, L, H * P + 2 * G * N)
                           .astype(np.float32)).to(cuda)
    x = xbc[..., :H * P].reshape(b, L, H, P)
    B = xbc[..., H * P:H * P + G * N].reshape(b, L, G, N)
    C = xbc[..., H * P + G * N:].reshape(b, L, G, N)
    dt = torch.from_numpy(np.log1p(np.exp(rs.randn(b, L, H)))
                          .astype(np.float32)).to(cuda)
    A = torch.from_numpy(-np.exp(rs.randn(H) * 0.3).astype(np.float32)) \
        .to(cuda)
    gy = torch.from_numpy(rs.randn(b, H, L, P).astype(np.float32)).to(cuda) \
        .transpose(1, 2)
    got = ssd_scan_backward(x, dt, A, B, C, gy, None, chunk=chunk)
    dense = ssd_scan_backward(x.contiguous(), dt, A, B.contiguous(),
                              C.contiguous(), gy.contiguous(), None,
                              chunk=chunk)
    for g, w in zip(got, dense):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_backward_kernels_raise_on_unsupported_inputs_on_card(cuda):
    """On CUDA tensors the backward kernels run or raise: a head dim the
    flash kernel has no tile for, a bf16 gradient it cannot read by
    cp.async, and a state width past the scan backward's N raise instead
    of falling back to a plain version."""
    q = torch.randn(1, 2, 16, 48, device=cuda)
    with pytest.raises(ValueError):
        flash_attention_backward(q, q, q, q, q)
    qb = torch.randn(1, 2, 16, 64, device=cuda).bfloat16()
    odd = torch.randn(1, 2, 16, 65, device=cuda).bfloat16()[..., 1:]
    with pytest.raises(ValueError):
        flash_attention_backward(qb, qb, qb, qb, odd)
    x = torch.randn(1, 64, 2, 16, device=cuda)
    dt = torch.rand(1, 64, 2, device=cuda)
    A = -torch.ones(2, device=cuda)
    Bm = torch.randn(1, 64, 1, 256, device=cuda)
    with pytest.raises(ValueError):
        ssd_scan_backward(x, dt, A, Bm, Bm, torch.randn_like(x), None)


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
