"""The port's Mamba-2 (SSD) pieces against the reference, on the CPU.

``kernels.ref.ssd_scan_ref`` (the CPU path of ``ops.ssd`` and the yardstick
of the CUDA ``ssd_scan``) is held against the reference's Pallas
``ssd_scan`` in interpret mode and its sequential oracle on the cases of
``tests/test_kernels.py:180-185`` (relative error of y and of the final
state under 2e-5 in f32 and 4e-2 in bf16, the reference test's bounds).
The causal conv, the one-token conv and SSD steps and both mixers are held
against ``repro.models.ssm`` on the same weights and inputs (f32, within
2e-5: sums in another order), including right-padded prefill through
``seq_lens`` and the returned decode state.  The CUDA kernel is held
against the plain version on the card in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import ssm

TOL = 2e-5
SSD_TOL = {"float32": 2e-5, "bfloat16": 4e-2}      # test_kernels.py:196
# (b, L, H, G, P, N, chunk): test_kernels.py:180-185
SSD_CASES = [(2, 128, 4, 1, 64, 32, 32), (1, 256, 8, 2, 32, 64, 64),
             (2, 64, 2, 2, 16, 16, 16), (1, 128, 24, 1, 64, 128, 64)]


def _ssd_inputs(b, L, H, G, P, N, seed=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, L, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(b, L, H))).astype(np.float32)
    A = (-np.exp(rs.randn(H) * 0.3)).astype(np.float32)
    B = rs.randn(b, L, G, N).astype(np.float32)
    C = rs.randn(b, L, G, N).astype(np.float32)
    return x, dt, A, B, C


def _cast(args, dtype, lib):
    """x, dt, B, C in ``dtype``; A stays f32 (as the reference test)."""
    out = []
    for i, a in enumerate(args):
        if lib == "jax":
            out.append(jnp.asarray(a, jnp.float32 if i == 2 else
                                   getattr(jnp, dtype)))
        else:
            t = torch.from_numpy(a)
            out.append(t if i == 2 else t.to(getattr(torch, dtype)))
    return out


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,L,H,G,P,N,chunk", SSD_CASES)
def test_ssd_plain_matches_reference(b, L, H, G, P, N, chunk, dtype):
    args = _ssd_inputs(b, L, H, G, P, N)
    y, st = ref.ssd_scan_ref(*_cast(args, dtype, "torch"), chunk=chunk)
    assert y.dtype == st.dtype == torch.float32
    assert y.shape == (b, L, H, P) and st.shape == (b, H, P, N)
    jargs = _cast(args, dtype, "jax")
    yr, sr = jref.ssd_scan_ref(*jargs)
    assert _rel(y, yr) < SSD_TOL["float32"]     # the same recurrence
    assert _rel(st, sr) < SSD_TOL["float32"]
    yp, sp = pallas_ssd(*jargs, chunk=chunk, interpret=True)
    assert _rel(y, yp) < SSD_TOL[dtype]
    assert _rel(st, sp) < SSD_TOL[dtype]


def test_ops_ssd_dispatches_cpu_to_plain_and_kernel_refuses_cpu():
    args = [torch.from_numpy(a) for a in _ssd_inputs(1, 40, 4, 2, 16, 8)]
    y, st = ops.ssd(*args, chunk=16)
    y2, st2 = ref.ssd_scan_ref(*args)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    before = ssd_scan.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(*args)
    assert ssd_scan.launches == before
    assert "ssd_scan" in build.SOURCES


def test_dt_zero_padding_carries_the_state_unchanged():
    """Right-padded positions (dt = 0) leave the state exactly as the last
    real position left it (ssm.py:185-189)."""
    x, dt, A, B, C = _ssd_inputs(1, 24, 2, 1, 8, 4)
    dt[:, 17:] = 0.0
    _, st_full = ref.ssd_scan_ref(*(torch.from_numpy(a)
                                    for a in (x, dt, A, B, C)))
    _, st_cut = ref.ssd_scan_ref(*(torch.from_numpy(a[:, :17])
                                   if a.ndim > 1 else torch.from_numpy(a)
                                   for a in (x, dt, A, B, C)))
    assert torch.equal(st_full, st_cut)


# --------------------------- conv and mixers ------------------------------ #
_JCFG = jax_get_config("mamba2-130m").reduced()
_CFG = get_config("mamba2-130m").reduced()


def _mamba_params(seed=0):
    jp = jssm.init_mamba_params(jax.random.PRNGKey(seed), _JCFG, jnp.float32)
    # non-trivial conv bias, A and D, so every term is exercised
    rs = np.random.RandomState(seed + 7)
    jp = dict(jp)
    jp["conv_b"] = jnp.asarray(rs.randn(_JCFG.conv_dim) * 0.1, jnp.float32)
    jp["A_log"] = jnp.asarray(rs.randn(_JCFG.ssm_nheads) * 0.3, jnp.float32)
    jp["D"] = jnp.asarray(1 + rs.randn(_JCFG.ssm_nheads) * 0.1, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


def test_causal_conv_and_decode_steps_match_reference():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 11, 6).astype(np.float32)
    w = rs.randn(4, 6).astype(np.float32)
    bias = rs.randn(6).astype(np.float32)
    got = ssm.causal_conv1d(*(torch.from_numpy(a) for a in (x, w, bias)))
    assert _err(got, jssm.causal_conv1d(x, w, bias)) <= TOL
    cs = rs.randn(2, 3, 6).astype(np.float32)
    y, st = ssm.conv_decode_step(*(torch.from_numpy(a)
                                   for a in (cs, x[:, 0], w, bias)))
    jy, jst = jssm.conv_decode_step(cs, x[:, 0], w, bias)
    assert _err(y, jy) <= TOL and _err(st, jst) == 0.0
    state = rs.randn(2, 4, 8, 5).astype(np.float32)
    xs = rs.randn(2, 4, 8).astype(np.float32)
    dt = np.abs(rs.randn(2, 4)).astype(np.float32)
    A = -np.abs(rs.randn(4)).astype(np.float32)
    Bm = rs.randn(2, 2, 5).astype(np.float32)
    Cm = rs.randn(2, 2, 5).astype(np.float32)
    args = (state, xs, dt, A, Bm, Cm)
    y, st = ssm.ssd_decode_step(*(torch.from_numpy(a) for a in args))
    jy, jst = jssm.ssd_decode_step(*args)
    assert _err(y, jy) <= TOL and _err(st, jst) <= TOL


@pytest.mark.parametrize("lens", [None, (37, 21)])
def test_mamba_mixer_fwd_matches_reference(lens):
    """Prefill mixer output and decode state, unpadded and right-padded
    (``seq_lens``); the reference scans with its chunked jnp path."""
    jp, tp = _mamba_params()
    x = np.random.RandomState(4).randn(2, 40, _CFG.d_model) \
        .astype(np.float32)
    sl = None if lens is None else np.asarray(lens, np.int32)
    jout, jc = jssm.mamba_mixer_fwd(
        jp, jnp.asarray(x), _JCFG, chunk=16, return_state=True,
        seq_lens=None if sl is None else jnp.asarray(sl))
    out, c = ssm.mamba_mixer_fwd(
        tp, torch.from_numpy(x), _CFG, return_state=True,
        seq_lens=None if sl is None else torch.from_numpy(sl))
    valid = np.ones((2, 40), bool) if sl is None else \
        np.arange(40)[None] < sl[:, None]
    assert _err(out.numpy() * valid[..., None],
                np.asarray(jout) * valid[..., None]) <= TOL
    assert _err(c["conv"], jc["conv"]) <= TOL
    assert _err(c["ssm"], jc["ssm"]) <= TOL
    assert ssm.mamba_mixer_fwd(tp, torch.from_numpy(x), _CFG).shape == \
        (2, 40, _CFG.d_model)


def test_mamba_mixer_decode_matches_reference():
    jp, tp = _mamba_params(1)
    rs = np.random.RandomState(5)
    x = rs.randn(3, _CFG.d_model).astype(np.float32)
    cache = {"conv": rs.randn(3, _CFG.ssm_conv - 1, _CFG.conv_dim)
             .astype(np.float32),
             "ssm": rs.randn(3, _CFG.ssm_nheads, _CFG.ssm_headdim,
                             _CFG.ssm_state).astype(np.float32)}
    jout, jc = jssm.mamba_mixer_decode(jp, jnp.asarray(x), _JCFG, cache)
    out, c = ssm.mamba_mixer_decode(
        tp, torch.from_numpy(x), _CFG,
        {k: torch.from_numpy(v) for k, v in cache.items()})
    assert _err(out, jout) <= TOL
    for k in ("conv", "ssm"):
        assert _err(c[k], jc[k]) <= TOL


def test_init_mamba_params_matches_reference_tree():
    jp = jssm.init_mamba_params(jax.random.PRNGKey(0), _JCFG, jnp.float32)
    tp = ssm.init_mamba_params(_CFG, torch.Generator().manual_seed(0),
                               torch.float32, "cpu")

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}

    assert shapes(tp) == shapes(jp)
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert float(dt.min()) >= 1e-3 - 1e-7 and float(dt.max()) <= 1e-1 + 1e-7
    assert torch.equal(tp["D"], torch.ones_like(tp["D"]))
