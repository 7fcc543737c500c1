"""The port's weight-transfer plane against the reference's, on the CPU.

Inputs come from numpy seeds and go to both packages.  The port's plain
dequant (``kernels.ref.dequant_ref``) is held to the reference's oracle and
its Pallas kernel in interpret mode at the reference test's tolerance
(atol = rtol = 1e-6); flatten keys, leaf specs and chunk digests must be
equal across the packages under every codec; a manifest built by either
package assembles in the other to the other's own output (atol 1e-6); the
codec bounds, integrity checks, history expiry and a mid-stream install
follow ``tests/test_transfer.py``.  Tests marked ``cuda`` hold the CUDA
``fused_dequant`` kernel against its plain version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.dequant import fused_dequant as pallas_dequant
from repro.models import init_params as jax_init_params
from repro.rl.harness import tiny_math_config as jax_tiny_math
from repro.transfer.chunkstore import ChunkStore as JaxChunkStore
from repro.transfer.chunkstore import flatten_params as jax_flatten
from repro_torch.configs import get_config, tiny_math_config
from repro_torch.data import tokenizer as tok
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dequant import fused_dequant
from repro_torch.models.convert import params_from_numpy
from repro_torch.transfer import codec as codec_mod
from repro_torch.transfer.chunkstore import (ChunkIntegrityError, ChunkStore,
                                             MissingChunkError,
                                             assemble_manifest,
                                             flatten_params)

TOL = dict(atol=1e-6, rtol=1e-6)


def _bf16_tensor(a):
    """An ml_dtypes bf16 numpy array as a torch bf16 tensor, same bits."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


def _dequant_inputs(R, C, base, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randint(-127, 128, (R, C)).astype(np.int8)
    scale = rng.uniform(1e-4, 1e-2, (C,)).astype(np.float32)
    b = rng.randn(R, C).astype(np.float32) if base else None
    return q, scale, b


# ------------------------------- dequant ---------------------------------- #
@pytest.mark.parametrize("R,C,base", [
    (8, 16, None),            # tiny leaf, no base (full int8 pull)
    (100, 37, "float32"),     # ragged rows, delta-accumulate
    (256, 128, "float32"),    # lane-aligned
    (1, 5, None),             # 1-D leaf viewed as a single row
    (100, 37, "bfloat16"),    # bf16 resident base
    (64, 128, "bfloat16"),
])
def test_dequant_ref_matches_reference(R, C, base):
    q, scale, b = _dequant_inputs(R, C, base)
    jb = None if b is None else jnp.asarray(b, getattr(jnp, base))
    want = np.asarray(jref.dequant_ref(jnp.asarray(q), jnp.asarray(scale),
                                       jb))
    pallas = np.asarray(pallas_dequant(jnp.asarray(q), jnp.asarray(scale),
                                       jb, block_rows=32, interpret=True))
    tb = None
    if jb is not None:
        tb = (_bf16_tensor(jb) if base == "bfloat16"
              else torch.from_numpy(b))
    before = fused_dequant.launches
    got = ref.dequant_ref(torch.from_numpy(q), torch.from_numpy(scale), tb)
    via_ops = ops.fused_dequant(torch.from_numpy(q), torch.from_numpy(scale),
                                tb)
    assert got.dtype == torch.float32 and got.shape == (R, C)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    assert torch.equal(via_ops, got)
    assert fused_dequant.launches == before      # CPU: no kernel launch


def test_dequant_kernel_refuses_cpu_tensors():
    q, scale, b = _dequant_inputs(4, 8, "float32")
    before = fused_dequant.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_dequant(torch.from_numpy(q), torch.from_numpy(scale),
                      torch.from_numpy(b))
    assert fused_dequant.launches == before


# ------------------------- flatten keys and order -------------------------- #
def _jcfg(name):
    if name == "tiny-math":
        return jax_tiny_math(), tiny_math_config()
    return (jax_get_config("qwen3-8b").reduced(vocab_size=tok.VOCAB_SIZE,
                                               dtype="bfloat16"),
            get_config("qwen3-8b").reduced(vocab_size=tok.VOCAB_SIZE,
                                           dtype="bfloat16"))


def _trees(name, seed=0):
    """(reference cfg, port cfg, v1 numpy tree, v2 numpy tree): v2 is v1
    plus seeded noise, cast back to each leaf's dtype."""
    jcfg, cfg = _jcfg(name)
    t1 = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                  jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed + 1)
    t2 = jax.tree.map(lambda a: (a.astype(np.float32) + 0.01 * rng.randn(
        *a.shape).astype(np.float32)).astype(a.dtype), t1)
    return jcfg, cfg, t1, t2


@pytest.mark.parametrize("name", ["tiny-math", "qwen3-8b-bf16"])
def test_flatten_keys_and_order_match_reference(name):
    _, cfg, t1, _ = _trees(name)
    want = jax_flatten(t1)
    got = flatten_params(params_from_numpy(t1, cfg, "cpu"))
    assert list(got) == list(want)
    for k in want:
        assert codec_mod.dtype_name(got[k]) == str(want[k].dtype)
        assert tuple(got[k].shape) == want[k].shape
        assert codec_mod.encode_leaf(got[k], "none") == want[k].tobytes()


# -------------------- manifests across the two packages -------------------- #
def _stores(name, chunk_bytes=4096):
    jcfg, cfg, t1, t2 = _trees(name)
    jstore, store = JaxChunkStore(chunk_bytes), ChunkStore(chunk_bytes)
    p1, p2 = (params_from_numpy(t, cfg, "cpu") for t in (t1, t2))
    for s, a, b in ((jstore, t1, t2), (store, p1, p2)):
        s.publish(1, a)
        s.publish(2, b)
    return jstore, store, (t1, t2), (p1, p2)


def _pull(store, m):
    return {c.digest: store.fetch(c.digest) for c in m.chunks}


@pytest.mark.parametrize("name", ["tiny-math", "qwen3-8b-bf16"])
@pytest.mark.parametrize("codec", ["none", "int8", "delta-int8"])
def test_manifest_digests_match_reference(name, codec):
    jstore, store, _, _ = _stores(name)
    jm = jstore.manifest(2, codec, base_version=1)
    m = store.manifest(2, codec, base_version=1)
    assert m.codec == jm.codec == codec
    assert [tuple(vars(s).values()) for s in m.leaves] == \
        [tuple(vars(s).values()) for s in jm.leaves]
    assert m.digests() == jm.digests()
    assert m.total_bytes == jm.total_bytes


@pytest.mark.parametrize("name", ["tiny-math", "qwen3-8b-bf16"])
@pytest.mark.parametrize("codec", ["none", "int8", "delta-int8"])
def test_manifests_assemble_across_packages(name, codec):
    """A reference manifest decoded by the port equals the reference's own
    decode, and a port manifest decoded by the reference equals the port's,
    within 1e-6 (the port decodes a delta on its resident bf16 / f32
    base)."""
    jstore, store, (t1, _), (p1, _) = _stores(name)
    jm = jstore.manifest(2, codec, base_version=1)
    m = store.manifest(2, codec, base_version=1)
    want = jax_flatten(jstore.assemble(jm, _pull(jstore, jm), like=t1,
                                       base_params=t1))
    got = flatten_params(assemble_manifest(jm, _pull(jstore, jm), like=p1,
                                           base_params=p1))
    back = jax_flatten(jstore.assemble(m, _pull(store, m), like=t1,
                                       base_params=t1))
    mine = flatten_params(store.assemble(m, _pull(store, m), like=p1,
                                         base_params=p1))
    for k in want:
        assert codec_mod.dtype_name(got[k]) == str(want[k].dtype)
        np.testing.assert_allclose(got[k].float().numpy(),
                                   want[k].astype(np.float32), **TOL)
        np.testing.assert_allclose(mine[k].float().numpy(),
                                   back[k].astype(np.float32), **TOL)


# ------------------------ codec bounds and integrity ----------------------- #
def _tiny_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"wte": torch.from_numpy(rng.randn(37, 16).astype(np.float32)),
            "blocks": {"0": {
                "w1": torch.from_numpy(rng.randn(16, 64).astype(np.float32)),
                "b1": torch.from_numpy(rng.randn(64).astype(np.float32))}},
            "head": torch.from_numpy(rng.randn(16, 37).astype(np.float32))}


def _assert_quant_bound(dec, want, basis):
    """Per-channel int8 bound: |dec - want| <= scale/2, scale from basis
    (the leaf itself, or the delta), over the codec's channel view."""
    b = np.asarray(basis, np.float32)
    rows = b.reshape(-1, b.shape[-1]) if b.ndim > 1 else b.reshape(-1, 1)
    scale = np.abs(rows).max(axis=0) / 127.0 + 1e-12
    err = np.abs(np.asarray(dec, np.float32)
                 - np.asarray(want, np.float32)).reshape(rows.shape)
    assert (err <= 0.5 * scale[None, :] + 1e-6).all(), err.max()


def test_manifest_roundtrip_bitexact_checksummed_and_complete():
    store = ChunkStore(chunk_bytes=1024)
    p = _tiny_params()
    store.publish(1, p)
    m = store.manifest(1, "none")
    assert m.n_chunks > 3 and m.total_bytes == store.raw_bytes(1)
    chunks = _pull(store, m)
    out = flatten_params(store.assemble(m, chunks, like=p))
    for k, v in flatten_params(p).items():
        assert torch.equal(out[k], v)
    bad = dict(chunks)
    bad[m.chunks[0].digest] = bytes(m.chunks[0].nbytes)
    with pytest.raises(ChunkIntegrityError):
        store.assemble(m, bad, like=p)
    short = dict(chunks)
    del short[m.chunks[-1].digest]
    with pytest.raises(MissingChunkError):
        store.assemble(m, short, like=p)


def test_history_expiry_drops_manifests_blobs_and_delta_bases():
    store = ChunkStore(chunk_bytes=1024, history=2)
    ps = [_tiny_params(seed) for seed in range(3)]
    store.publish(1, ps[0])
    m1 = store.manifest(1, "int8")
    store.publish(2, ps[1])
    store.publish(3, ps[2])                      # v1 expires
    assert store.versions() == [2, 3]
    assert all(store.fetch(d) is None for d in m1.digests())
    assert store.manifest(3, "delta-int8", base_version=1).codec == "int8"
    d = store.manifest(3, "delta-int8", base_version=2)
    assert d.codec == "delta-int8" and d.base_version == 2
    assert store.manifest(3, "delta-int8").codec == "int8"


def test_int8_codec_error_bounds():
    store = ChunkStore(chunk_bytes=1024)
    p = _tiny_params()
    store.publish(1, p)
    m = store.manifest(1, "int8")
    assert m.total_bytes < store.raw_bytes(1) * 0.6      # ~2x compression
    out = flatten_params(store.assemble(m, _pull(store, m), like=p))
    for k, v in flatten_params(p).items():
        _assert_quant_bound(out[k], v, v)


def test_delta_int8_codec_error_bounds():
    store = ChunkStore(chunk_bytes=1024)
    p1 = _tiny_params()
    rng = np.random.RandomState(9)
    p2 = {"wte": p1["wte"] + 0.01 * torch.from_numpy(
              rng.randn(37, 16).astype(np.float32)),
          "blocks": {"0": {k: v + 0.01 * torch.from_numpy(
              rng.randn(*v.shape).astype(np.float32))
              for k, v in p1["blocks"]["0"].items()}},
          "head": p1["head"] * 1.01}
    store.publish(1, p1)
    store.publish(2, p2)
    m = store.manifest(2, "delta-int8", base_version=1)
    assert m.codec == "delta-int8" and m.base_version == 1
    out = flatten_params(store.assemble(m, _pull(store, m), like=p1,
                                        base_params=p1))
    f1, f2 = flatten_params(p1), flatten_params(p2)
    for k in f2:
        _assert_quant_bound(out[k], f2[k], f2[k] - f1[k])
    assert store.manifest(2, "delta-int8", base_version=99).codec == "int8"


def test_codec_none_carries_bf16_bits():
    rng = np.random.RandomState(3)
    t = torch.from_numpy(rng.randn(5, 7).astype(np.float32)).bfloat16()
    store = ChunkStore(chunk_bytes=16)
    store.publish(1, {"w": t})
    m = store.manifest(1, "none")
    assert m.leaves[0].dtype == "bfloat16" and m.total_bytes == 70
    out = store.assemble(m, _pull(store, m), like={"w": t})
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], t)


def test_weight_store_synthetic_manifests_and_int8_helpers_match_reference():
    """The registry's sim mode serves the reference's synthetic manifests
    (same pseudo-digests and sizes); its real mode publishes into the chunk
    store; the numpy int8 helpers give the reference's bytes."""
    from repro.core.weight_transfer import TransferAgent as JaxAgent
    from repro.core.weight_transfer import WeightStore as JaxStore
    from repro.transfer.codec import dequantize_int8 as jax_deq
    from repro.transfer.codec import quantize_int8 as jax_q
    from repro_torch.core.kv_migration import KVExport
    from repro_torch.core.weight_transfer import TransferAgent, WeightStore
    from repro_torch.transfer import dequantize_int8, quantize_int8
    for codec, base in (("none", None), ("int8", None), ("delta-int8", 3),
                        ("delta-int8", None)):
        stores = [S([A(0, 8.0)], weight_bytes=8e9, sim_chunks=16)
                  for S, A in ((WeightStore, TransferAgent),
                               (JaxStore, JaxAgent))]
        for st in stores:
            st.publish(4)
        m, jm = (st.manifest(codec, base_version=base) for st in stores)
        assert (m.codec, m.base_version, m.total_bytes, m.digests(),
                [c.nbytes for c in m.chunks]) == \
            (jm.codec, jm.base_version, jm.total_bytes, jm.digests(),
             [c.nbytes for c in jm.chunks])
        assert stores[0].fetch_fn() is None
    agent = TransferAgent(0, 8.0, active_pulls=4)
    assert agent.share_gbps() == 2.0
    real = WeightStore([agent], chunkstore=ChunkStore(chunk_bytes=512))
    p = _tiny_params()
    real.publish(1, p)
    m = real.manifest("int8")
    assert m.version == 1 and real.fetch_fn()(m.chunks[0].digest)
    blobs = _pull(real.chunkstore, m)
    exp = KVExport(1, m, agent, "int8", kv_tokens=0, req_ids=[],
                   blobs=blobs)
    assert exp.fetch_fn()(m.chunks[0].digest) == blobs[m.chunks[0].digest]
    assert KVExport(2, m, agent, "none", 0, []).fetch_fn() is None
    a = np.random.RandomState(4).randn(6, 10).astype(np.float32)
    (q, s), (jq, js) = quantize_int8(a), jax_q(a)
    assert q.tobytes() == jq.tobytes() and s.tobytes() == js.tobytes()
    assert dequantize_int8(q, s, a.shape).tobytes() == \
        jax_deq(jq, js, a.shape).tobytes()


# ------------------------------ live install ------------------------------- #
def test_engine_swap_weights_midstream_stamps_and_bounds():
    from repro_torch.rl.sampler import request_key
    from repro_torch.serving.engine import InferenceEngine
    cfg = get_config("qwen2-7b").reduced(n_heads=2, n_kv_heads=1,
                                         d_model=32, head_dim=16, d_ff=64,
                                         vocab_size=tok.VOCAB_SIZE)
    jcfg = jax_get_config("qwen2-7b").reduced(
        n_heads=2, n_kv_heads=1, d_model=32, head_dim=16, d_ff=64,
        vocab_size=tok.VOCAB_SIZE)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    params1 = params_from_numpy(tree, cfg, "cpu")
    params2 = params_from_numpy(jax.tree.map(lambda x: x * 1.01, tree), cfg,
                                "cpu")
    store = ChunkStore(chunk_bytes=2048)
    store.publish(1, params1)
    store.publish(2, params2)
    m = store.manifest(2, "delta-int8", base_version=1)
    installed = store.assemble(m, _pull(store, m), like=params1,
                               base_params=params1)
    f_i, f_1, f_2 = (flatten_params(installed), flatten_params(params1),
                     flatten_params(params2))
    for k in f_2:
        _assert_quant_bound(f_i[k], f_2[k], f_2[k] - f_1[k])

    eng = InferenceEngine(cfg, params1, max_batch=4, slab_len=64,
                          temperature=1.0, weight_version=1, device="cpu")
    prompt = tok.encode("12+34=")
    versions = {0: [], 1: []}
    finished = set()
    for rid in versions:
        eng.add_request(rid, prompt, request_key(0, rid),
                        len(prompt) + 10, len(prompt))
    for step in range(30):
        if step == 4:       # v2 lands mid-generation: swap, don't drop
            eng.swap_weights(installed, 2)
        for ev in eng.step():
            versions[ev.req_id].append(ev.weight_version)
            if ev.finished:
                finished.add(ev.req_id)
        if finished == set(versions):
            break
    assert finished == {0, 1}                        # nothing dropped
    for vs in versions.values():
        assert vs == sorted(vs)                      # monotone versions
        assert vs[0] == 1 and (vs[-1] == 2 or len(vs) <= 4)


# ------------------------------ on the card -------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


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
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["int8", "delta-int8"])
def test_install_on_card_launches_once_per_int8_leaf(cuda, codec):
    _, store, _, (p1, _) = _stores("qwen3-8b-bf16")
    like = jax.tree.map(lambda t: t.to(cuda), p1)
    m = store.manifest(2, codec, base_version=1)
    before = fused_dequant.launches
    got = flatten_params(store.assemble(m, _pull(store, m), like=like,
                                        base_params=like))
    assert fused_dequant.launches - before == len(m.leaves)
    host = flatten_params(assemble_manifest(m, _pull(store, m), like=p1,
                                            base_params=p1))
    for k in host:
        torch.testing.assert_close(got[k].float(), host[k].float(), **TOL)
