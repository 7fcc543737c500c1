"""Kernel entry points the model and the transfer codec call: a CPU tensor
goes to the plain PyTorch version, a CUDA tensor to the hand-written
kernel.  There is no other path: on a CUDA tensor the kernel runs or
raises.

The trainer's two entries, ``attention_bshd`` and ``ssd``, also take
DTensors (the sharded trainer): the op then runs on each rank's local
shards (``_rank_local``) and its outputs are wrapped back with the same
placements.  The batch stays sharded over the data dims; the heads stay
sharded over a mesh dim only where every input's head (or group) dim
divides it, so that a rank's q heads and the kv heads (SSM groups) they
read land on the same rank; otherwise the inputs are first replicated
over that dim and the work repeats on each of its ranks."""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention as \
    _slab_decode_kernel
from repro_torch.kernels.dequant import fused_dequant as _dequant_kernel
from repro_torch.kernels.flash_attention import flash_attention as \
    _flash_kernel
from repro_torch.kernels.flash_attention import flash_attention_backward \
    as _flash_bwd_kernel
from repro_torch.kernels.flash_attention import tma_layout_ok
from repro_torch.kernels.paged_attention import paged_decode_attention as \
    _decode_kernel
from repro_torch.kernels.paged_prefill import paged_prefill_attention as \
    _prefill_kernel
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_kernel
from repro_torch.kernels.ssd_scan import ssd_scan_backward as _ssd_bwd_kernel

# every kernel wrapper; each counts its launches in ``.launches``
KERNEL_WRAPPERS = (_decode_kernel, _prefill_kernel, _dequant_kernel,
                   _flash_kernel, _slab_decode_kernel, _ssd_kernel,
                   _flash_bwd_kernel, _ssd_bwd_kernel)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           cap: float = 0.0, scale=None):
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                              block_tables, lengths, cap=cap,
                                              scale=scale)
    return _decode_kernel(q, k_pages, v_pages, block_tables, lengths,
                          cap=cap, scale=scale)


def paged_prefill_attention(q, k, v, k_pages, v_pages, block_tables, offsets,
                            chunk_lens, *, cap: float = 0.0, scale=None):
    if q.device.type == "cpu":
        return ref.paged_prefill_attention_ref(q, k, v, k_pages, v_pages,
                                               block_tables, offsets,
                                               chunk_lens, cap=cap,
                                               scale=scale)
    return _prefill_kernel(q, k, v, k_pages, v_pages, block_tables, offsets,
                           chunk_lens, cap=cap, scale=scale)


def fused_dequant(q, scale, base=None):
    """f32 [R, C] = (base or 0) + q * scale; q [R, C] int8, scale [C] f32,
    base [R, C] f32 / bf16 or None."""
    if q.device.type == "cpu":
        return ref.dequant_ref(q, scale, base)
    return _dequant_kernel(q, scale, base)


def _flash_backward(q, k, v, grad_out, causal: bool, window: int,
                    cap: float, *, out):
    """(dq, dk, dv) at (q, k, v) for the output gradient ``grad_out``,
    ``out`` the forward's output: the backward kernel on CUDA tensors, its
    plain version on CPU tensors.  The reference's Pallas kernel has no
    backward (its trainer differentiates its jnp path); these are the
    same gradients."""
    opts = dict(causal=causal, window=window, cap=cap)
    if q.device.type == "cpu":
        return ref.flash_attention_backward_ref(q, k, v, out, grad_out,
                                                **opts)
    # autograd may hand over any layout; the kernel reads rows in place
    if not tma_layout_ok(grad_out.data_ptr(), grad_out.stride(),
                         grad_out.element_size()):
        grad_out = grad_out.contiguous()
    return _flash_bwd_kernel(q, k, v, out, grad_out, **opts)


class _FlashAttention(torch.autograd.Function):
    """Forward through the kernel; backward through ``_flash_backward``
    (the backward kernel on the card).  Tensors are [B, H, S, d] /
    [B, K, S, d] views."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap):
        out = _flash_kernel(q, k, v, causal=causal, window=window, cap=cap)
        ctx.save_for_backward(q, k, v, out)
        ctx.opts = (causal, window, cap)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out = ctx.saved_tensors
        return (*_flash_backward(q, k, v, grad_out, *ctx.opts, out=out),
                None, None, None)


def _rank_local(fn, args, roles, out_roles, out_shapes, heads_ok):
    """``fn`` on each rank's local shards of ``args`` (DTensors, or plain
    tensors taken as replicated), its outputs wrapped back as DTensors of
    ``out_shapes``.  A role is (batch dim, head dim) of a tensor, either
    ``None``.  Each mesh dim of the first DTensor's placements that shards
    its batch dim shards every batch dim; one that shards its head dim,
    where ``heads_ok`` [mesh dim size] holds, shards every head dim; any
    other is replicated.  A tensor without the dim a mesh dim shards
    (A has no batch, B / C of one group no head) is replicated there and
    its gradient is a partial sum over that dim."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    lead = next(a for a in args if isinstance(a, DTensor))
    mesh, (lb, lh) = lead.device_mesh, roles[args.index(lead)]
    kinds = ["batch" if pl == Shard(lb) else
             "head" if lh is not None and pl == Shard(lh)
             and heads_ok(mesh.size(i)) else None
             for i, pl in enumerate(lead.placements)]

    def placements(role, grad=False):
        dims = {"batch": role[0], "head": role[1]}
        return tuple(Replicate() if k is None else
                     Shard(dims[k]) if dims[k] is not None else
                     Partial() if grad else Replicate() for k in kinds)

    local = []
    for a, role in zip(args, roles):
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        a = a.redistribute(mesh, placements(role))
        local.append(a.to_local(grad_placements=placements(role, True)))
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    # contiguous: the wrapper's global strides are row-major
    wrapped = tuple(DTensor.from_local(
        o.contiguous(), mesh, placements(r), run_check=False,
        shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())
        for o, r, shape in zip(outs, out_roles, out_shapes))
    return wrapped[0] if single else wrapped


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def attention_bshd(q, k, v, *, causal: bool = True, window: int = 0,
                   cap: float = 0.0):
    """The model's full-sequence attention: q [B, S, H, d] unscaled,
    k/v [B, S, K, d] -> [B, S, H, d] in q's dtype.  Differentiable on both
    devices: on the CPU through the plain version, on CUDA through the
    forward and backward kernels.  On
    DTensors it runs rank-local (see the module note): heads stay
    sharded over a mesh dim that divides both H and K."""
    if _is_dtensor(q):
        H, K = q.shape[2], k.shape[2]
        role = (0, 2)
        return _rank_local(
            lambda *a: attention_bshd(*a, causal=causal, window=window,
                                      cap=cap),
            [q, k, v], [role] * 3, [role], [tuple(q.shape)],
            lambda n: H % n == 0 and K % n == 0)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if q.device.type == "cpu":
        out = ref.flash_attention_ref(qt, kt, vt, causal=causal,
                                      window=window, cap=cap)
    else:
        out = _FlashAttention.apply(qt, kt, vt, causal, window, cap)
    return out.transpose(1, 2)


def decode_bshd(q, k_cache, v_cache, lengths, *, window: int = 0,
                cap: float = 0.0, scale=None):
    """One query token against a slab (or ring) cache: q [B, 1, H, d];
    k_cache/v_cache [B, T, K, d], read in place as [B, K, T, d] views;
    lengths [B] int32.  Returns [B, 1, H, d] in q's dtype."""
    qt = q[:, 0].contiguous()
    kt, vt = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    if q.device.type == "cpu":
        out = ref.decode_attention_ref(qt, kt, vt, lengths, window=window,
                                       cap=cap, scale=scale)
    else:
        out = _slab_decode_kernel(qt, kt, vt, lengths, window=window,
                                  cap=cap, scale=scale)
    return out[:, None]


def _ssd_backward(x, dt, A, B, C, grad_y, grad_state, chunk: int):
    """(dx, ddt, dA, dB, dC) of the scan at (x, dt, A, B, C) for the
    gradients of its y and of its final state (either ``None`` when that
    output is unused): the backward kernel on CUDA tensors, its plain
    version on CPU tensors.  The reference's Pallas kernel has no backward
    (its trainer differentiates its chunked jnp scan); these are the same
    gradients."""
    if x.device.type == "cpu":
        return ref.ssd_scan_backward_ref(x, dt, A, B, C, grad_y, grad_state,
                                         chunk=chunk)
    if grad_y is not None and grad_y.stride(-1) != 1:
        grad_y = grad_y.contiguous()
    return _ssd_bwd_kernel(x, dt, A, B, C, grad_y, grad_state, chunk=chunk)


class _SSDScan(torch.autograd.Function):
    """Forward through the scan kernel; backward through
    ``_ssd_backward`` (the backward kernel on the card).  Both outputs
    carry a gradient: the final state's is ``None`` when the caller does
    not use the state (the train forward uses y only)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return _ssd_kernel(x, dt, A, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        return (*_ssd_backward(*ctx.saved_tensors, grad_y, grad_state,
                               ctx.chunk), None)


def ssd(x, dt, A, B, C, *, chunk: int = 64):
    """The Mamba-2 SSD scan from a zero state: (y [b, L, H, P], final
    state [b, H, P, N]), both f32.  Differentiable on both devices: on the
    CPU through the plain sequential version, on CUDA through the forward
    and backward kernels.  On
    DTensors it runs rank-local (see the module note): heads stay sharded
    over a mesh dim that divides H, with B / C's groups sharded alike
    where it divides G too, or whole where there is one group."""
    if _is_dtensor(x):
        b, L, H, P = x.shape
        G, N = B.shape[2], B.shape[3]
        # one group is read by every head: whole on each rank
        bc = (0, None) if G == 1 else (0, 2)
        return _rank_local(
            lambda *a: ssd(*a, chunk=chunk), [x, dt, A, B, C],
            [(0, 2), (0, 2), (None, 0), bc, bc], [(0, 2), (0, 1)],
            [(b, L, H, P), (b, H, P, N)],
            lambda n: H % n == 0 and (G % n == 0 or G == 1))
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, B, C, chunk=chunk)
    return _SSDScan.apply(x, dt, A, B, C, chunk)
