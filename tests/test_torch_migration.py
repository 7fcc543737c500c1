"""Zero-recompute KV migration in the port, on the CPU, and across packages.

Ports of ``tests/test_kv_migration.py``: a request exported mid-decode
travels as a KV manifest (codec ``none`` bit-exact, ``int8`` per-page
quant) and resumes on the destination with ZERO prefill, emitting the
tokens of an unmigrated run; GRPO siblings ship shared prompt pages once
and re-adopt them by refcount; a partial group lands with only the pages
it references; export -> import -> free cycles leak no pages.  Across
packages, an export from either engine, carried by its own package's
manifest and assembled and imported by the other, continues the
reference's unmigrated greedy tokens (logprobs within 1e-4, f32 sums in
another order).  Weights are the reference's ``init_params`` carried into
the port.  Ring / SSM state and the manager-level paths wait for the slices
that port those families and the control plane.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.models import init_params as jax_init_params
from repro.rl.sampler import request_key as jax_request_key
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.transfer.chunkstore import assemble_kv_state as jax_assemble_kv
from repro.transfer.chunkstore import build_kv_manifest as jax_build_kv
from repro_torch.configs import get_config
from repro_torch.data import tokenizer as tok
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.kv_cache import POOL_KEYS
from repro_torch.rl.sampler import request_key
from repro_torch.serving.engine import AdmissionError, InferenceEngine
from repro_torch.transfer import codec as codec_mod
from repro_torch.transfer.chunkstore import (LeafSpec, assemble_kv_state,
                                             build_kv_manifest)

LP_TOL = 1e-4
_SMALL = dict(n_heads=2, n_kv_heads=1, d_model=32, head_dim=16, d_ff=64,
              vocab_size=tok.VOCAB_SIZE)
_JCFG = jax_get_config("qwen2-7b").reduced(**_SMALL)
_CFG = get_config("qwen2-7b").reduced(**_SMALL)
_JPARAMS = jax_init_params(_JCFG, jax.random.PRNGKey(0))
_PARAMS = params_from_numpy(jax.tree.map(np.asarray, _JPARAMS), _CFG, "cpu")


def _kw(**eng_kw):
    kw = dict(max_batch=4, slab_len=64, temperature=1.0, page_size=8)
    kw.update(eng_kw)
    return kw


def _mk(**eng_kw):
    kw = _kw(**eng_kw)
    return lambda: InferenceEngine(_CFG, _PARAMS, device="cpu", **kw)


def _mk_jax(**eng_kw):
    kw = _kw(**eng_kw)
    return lambda: JaxEngine(_JCFG, _JPARAMS, use_pallas=False, **kw)


def _drive(eng, rid, prompt, key, max_total, n_steps=None, add=True):
    if add:
        eng.add_request(rid, prompt, key, max_total, len(prompt))
    out, done = [], False
    while not done and (n_steps is None or len(out) < n_steps):
        evs = eng.step()
        mine = [e for e in evs if e.req_id == rid]
        if not mine:
            if rid not in eng.active_request_ids():
                break
            continue
        for e in mine:
            out.append((e.token, e.logprob))
            done = e.finished
    return out


def _drive_group(eng, rids, n_steps=None):
    out = {r: [] for r in rids}
    done = set()
    steps = 0
    while len(done) < len(rids) and (n_steps is None or steps < n_steps):
        evs = eng.step()
        steps += 1
        for e in evs:
            if e.req_id in out and e.req_id not in done:
                out[e.req_id].append((e.token, e.logprob))
                if e.finished:
                    done.add(e.req_id)
    return out, done


def _migrate_via_manifest(src, dst, req_ids, codec="none",
                          chunk_bytes=1 << 12):
    """Export -> chunk manifest -> (local) blob fetch -> import."""
    state = src.export_request_state(req_ids)
    m, blobs, meta = build_kv_manifest(1, state, codec=codec,
                                       chunk_bytes=chunk_bytes)
    for rid in req_ids:
        src.drop_request(rid)
    dst.import_request_state(assemble_kv_state(m, blobs, meta))
    return state, m


def _toks(evs):
    return [t for t, _ in evs]


# --------------------------------------------------------------------------- #
# bit-exactness (codec none)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_kv_migration_bit_exact_zero_prefill(temperature):
    mk = _mk(temperature=temperature)
    prompt = tok.encode("12+34=")
    key = request_key(7, 42)
    mt = len(prompt) + 24
    full = _drive(mk(), 42, prompt, key, mt)
    engB = mk()
    part = _drive(engB, 42, prompt, key, mt, n_steps=6)
    _migrate_via_manifest(engB, engC := mk(), [42])
    rest = _drive(engC, 42, prompt, key, mt, add=False)
    assert part + rest == full            # tokens and logprobs, exactly
    assert engC.n_prefills == 0 and engC.n_prefill_tokens == 0
    assert engC.n_kv_import_tokens == len(prompt) + len(part) - 1
    assert engB.n_active == 0 and engB.alloc.n_free == \
        engB.alloc.num_pages - 1


@pytest.mark.parametrize("page_size", [4, 16])
def test_kv_migration_small_pages_unaligned_cut(page_size):
    mk = _mk(page_size=page_size, slab_len=32)
    prompt = tok.encode("25*4=")
    key = request_key(5, 9)
    mt = len(prompt) + 20
    full = _drive(mk(), 9, prompt, key, mt)
    engB = mk()
    part = _drive(engB, 9, prompt, key, mt, n_steps=page_size + 1)
    _migrate_via_manifest(engB, engC := mk(), [9])
    rest = _drive(engC, 9, prompt, key, mt, add=False)
    assert _toks(part) + _toks(rest) == _toks(full)
    assert engC.n_prefill_tokens == 0


def test_import_rejects_page_size_mismatch_and_short_slots():
    prompt = tok.encode("1+1=")
    engB = _mk()()
    _drive(engB, 1, prompt, request_key(0, 1), len(prompt) + 12, n_steps=3)
    state = engB.export_request_state([1])
    with pytest.raises(AdmissionError, match="page_size"):
        _mk(page_size=4)().import_request_state(state)
    full = _mk(max_batch=1)()
    full.add_request(2, prompt, request_key(0, 2), len(prompt) + 12,
                     len(prompt))
    with pytest.raises(AdmissionError, match="engine full"):
        full.import_request_state(state)
    with pytest.raises(KeyError):
        engB.export_request_state([99])


def test_import_grows_the_pool_and_writes_after_growth():
    """An import into a pool too small for the pages grows it first and
    writes the pages into the grown pools."""
    prompt = tok.encode("12+34=46. 7*8=56. 9-4=5, 6+6=")     # 30 tokens
    key = request_key(1, 3)
    mt = len(prompt) + 16
    mk = _mk(temperature=0.0, page_size=4)
    full = _drive(mk(), 3, prompt, key, mt)
    engB = mk()
    part = _drive(engB, 3, prompt, key, mt, n_steps=4)
    engC = _mk(temperature=0.0, page_size=4, slab_len=4, max_batch=1)()
    pages0 = engC.alloc.num_pages
    _migrate_via_manifest(engB, engC, [3])
    assert engC.alloc.num_pages > pages0
    assert engC.cache["k_pages"].shape[1] == engC.alloc.num_pages
    rest = _drive(engC, 3, prompt, key, mt, add=False)
    assert _toks(part) + _toks(rest) == _toks(full)


# --------------------------------------------------------------------------- #
# GRPO group migration: shared prompt pages ship once, refcount adoption
# --------------------------------------------------------------------------- #
def test_group_migration_ships_shared_prompt_pages_once():
    mk = _mk(page_size=4)
    prompt = tok.encode("123+456=")
    members = [(i, request_key(3, i), len(prompt) + 12) for i in range(3)]
    engA = mk()
    engA.add_group(members, prompt, len(prompt))
    ref_out, _ = _drive_group(engA, [0, 1, 2])
    engB = mk()
    engB.add_group(members, prompt, len(prompt))
    part, done = _drive_group(engB, [0, 1, 2], n_steps=4)
    assert not done, "siblings must still be mid-decode at the cut"
    state = engB.export_request_state([0, 1, 2])
    n_table_entries = sum(len(r["page_idx"]) for r in state["requests"])
    assert state["n_pages"] < n_table_entries
    assert engB.n_kv_export_pages == state["n_pages"]
    m, blobs, meta = build_kv_manifest(2, state, codec="none",
                                       chunk_bytes=1 << 12)
    for rid in [0, 1, 2]:
        engB.drop_request(rid)
    engC = mk()
    engC.import_request_state(assemble_kv_state(m, blobs, meta))
    assert engC.n_kv_import_pages == state["n_pages"]
    shared = {engC.slots[s].table[0] for s in range(3)}
    assert any(engC.alloc.ref[p] == 3 for p in shared)
    rest, _ = _drive_group(engC, [0, 1, 2])
    for rid in [0, 1, 2]:
        assert _toks(part[rid]) + _toks(rest[rid]) == _toks(ref_out[rid])
    assert engC.n_prefill_tokens == 0


def test_mid_group_partial_migration():
    """Only a SUBSET of a group migrates: the destination allocates only
    the pages that subset references; the stay-behind sibling continues on
    the source — both remain bit-exact."""
    mk = _mk(page_size=4)
    prompt = tok.encode("9*9=")
    members = [(i, request_key(4, i), len(prompt) + 10) for i in range(3)]
    engA = mk()
    engA.add_group(members, prompt, len(prompt))
    ref_out, _ = _drive_group(engA, [0, 1, 2])
    engB = mk()
    engB.add_group(members, prompt, len(prompt))
    part, _ = _drive_group(engB, [0, 1, 2], n_steps=3)
    state = engB.export_request_state([0, 1, 2])
    m, blobs, meta = build_kv_manifest(3, state, codec="none",
                                       chunk_bytes=1 << 12)
    engB.drop_request(0)
    engB.drop_request(1)
    engC = mk()
    free0 = engC.alloc.n_free
    engC.import_request_state(assemble_kv_state(m, blobs, meta),
                              only=[0, 1])
    assert 2 not in engC.active_request_ids()
    used = {i for r in state["requests"] if r["req_id"] in (0, 1)
            for i in r["page_idx"]}
    assert free0 - engC.alloc.n_free == len(used)
    restC, _ = _drive_group(engC, [0, 1])
    restB, _ = _drive_group(engB, [2])
    for rid, rest in [(0, restC[0]), (1, restC[1]), (2, restB[2])]:
        assert _toks(part[rid]) + _toks(rest) == _toks(ref_out[rid])


def test_drop_waiting_request_frees_its_row():
    eng = _mk()()
    prompt = tok.encode("3*3=")
    eng.add_group([(i, request_key(0, i), len(prompt) + 5) for i in (1, 2)],
                  prompt, len(prompt))
    free0 = eng.free_slots()
    assert eng.drop_request(1) == prompt and eng.free_slots() == free0 + 1
    assert eng.drop_request(2) == prompt and not eng.waiting
    assert eng.alloc.n_free == eng.alloc.num_pages - 1
    assert eng.drop_request(7) is None


# --------------------------------------------------------------------------- #
# int8 per-page codec: error bound vs the ref oracle
# --------------------------------------------------------------------------- #
def test_int8_kv_page_error_bound_vs_ref_oracle():
    rng = np.random.RandomState(0)
    page = rng.randn(8, 2, 16).astype(np.float32) * 3.0   # [ps, K, dh]
    payload = codec_mod.encode_leaf(torch.from_numpy(page), "int8")
    spec = LeafSpec("kv:page:0:x", page.shape, "float32", "int8", 0,
                    len(payload))
    out = codec_mod.decode_leaf(payload, spec).numpy()
    flat = page.reshape(-1, page.shape[-1])
    scale = np.abs(flat).max(axis=0) / 127.0 + 1e-12
    err = np.abs(out.reshape(-1, page.shape[-1]) - flat)
    assert (err <= scale[None, :] / 2 + 1e-7).all()
    n = page.size
    q = np.frombuffer(payload[:n], np.int8).reshape(-1, page.shape[-1])
    s = np.frombuffer(payload[n:], np.float32)
    oracle = np.asarray(jref.dequant_ref(q, s, None))
    np.testing.assert_allclose(out.reshape(oracle.shape), oracle, atol=0)


def test_int8_kv_migration_runs_and_bounds_state_error():
    mk = _mk(temperature=0.0)
    prompt = tok.encode("12+34=")
    key = request_key(7, 8)
    mt = len(prompt) + 16
    engB = mk()
    _drive(engB, 8, prompt, key, mt, n_steps=5)
    state = engB.export_request_state([8])
    m, blobs, meta = build_kv_manifest(4, state, codec="int8",
                                       chunk_bytes=1 << 12)
    assert m.total_bytes < sum(v.numel() * v.element_size()
                               for v in state["pages"].values())
    s2 = assemble_kv_state(m, blobs, meta)
    for k, src in state["pages"].items():
        src, got = src.float().numpy(), s2["pages"][k].float().numpy()
        # per page x head-dim channel, as the manifest quantizes them
        for j in range(src.shape[1]):
            flat = src[:, j].reshape(-1, src.shape[-1])
            scale = np.abs(flat).max(axis=0) / 127.0 + 1e-12
            assert (np.abs(got[:, j] - src[:, j]).reshape(flat.shape)
                    <= scale[None, :] / 2 + 1e-7).all(), k
    engC = mk()
    engC.import_request_state(s2)
    rest = _drive(engC, 8, prompt, key, mt, add=False)
    assert rest and engC.n_prefill_tokens == 0


# --------------------------------------------------------------------------- #
# allocator hygiene across export -> import -> free cycles
# --------------------------------------------------------------------------- #
def test_export_import_free_cycles_leak_no_pages():
    mk = _mk(page_size=4)
    prompt = tok.encode("11+22=")
    eng_src, eng_dst = mk(), mk()
    free_src0, free_dst0 = eng_src.alloc.n_free, eng_dst.alloc.n_free
    for cycle in range(3):
        members = [(100 * cycle + i, request_key(cycle, i),
                    len(prompt) + 8) for i in range(2)]
        eng_src.add_group(members, prompt, len(prompt))
        rids = [m[0] for m in members]
        _drive_group(eng_src, rids, n_steps=3)
        live = [r for r in rids if r in eng_src.active_request_ids()]
        if live:
            state = eng_src.export_request_state(live)
            m, blobs, meta = build_kv_manifest(10 + cycle, state,
                                               codec="none")
            for rid in live:
                eng_src.drop_request(rid)
            eng_dst.import_request_state(assemble_kv_state(m, blobs, meta))
            _drive_group(eng_dst, live)          # run to completion (frees)
    assert eng_src.alloc.n_free == free_src0
    assert eng_dst.alloc.n_free == free_dst0
    assert (eng_src.alloc.ref[1:] == 0).all()
    assert (eng_dst.alloc.ref[1:] == 0).all()


# --------------------------------------------------------------------------- #
# across packages: reference <-> port on the same weights, greedy
# --------------------------------------------------------------------------- #
_GROUP_PROMPT = tok.encode("123+456=")
_SINGLE_PROMPT = tok.encode("7*8=")


def _admit(eng, kf):
    eng.add_group([(i, kf(3, i), len(_GROUP_PROMPT) + 14) for i in range(2)],
                  _GROUP_PROMPT, len(_GROUP_PROMPT))
    eng.add_request(5, _SINGLE_PROMPT, kf(3, 5), len(_SINGLE_PROMPT) + 12,
                    len(_SINGLE_PROMPT))
    return [0, 1, 5]


def _assert_continues(part, rest, full):
    for rid in full:
        got = part[rid] + rest[rid]
        assert _toks(got) == _toks(full[rid]), rid
        np.testing.assert_allclose([lp for _, lp in got],
                                   [lp for _, lp in full[rid]], atol=LP_TOL)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_cross_package_migration_continues_reference_tokens(direction):
    """Export mid-generation from one package's engine, carry the state in
    that package's KV manifest, assemble and import it in the other's
    engine: the continuation equals the reference's unmigrated greedy
    stream with zero prefill on the destination."""
    mk_jax, mk_port = _mk_jax(temperature=0.0), _mk(temperature=0.0)
    engA = mk_jax()
    rids = _admit(engA, jax_request_key)
    full, done = _drive_group(engA, rids)
    assert done == set(rids)
    if direction == "reference_to_port":
        src, kf, build = mk_jax(), jax_request_key, jax_build_kv
        dst, assemble = mk_port(), assemble_kv_state
    else:
        src, kf, build = mk_port(), request_key, build_kv_manifest
        dst, assemble = mk_jax(), jax_assemble_kv
    _admit(src, kf)
    part, done = _drive_group(src, rids, n_steps=4)
    assert not done
    state = src.export_request_state(src.exportable_request_ids())
    assert sorted(state["pages"]) == sorted(POOL_KEYS.values())
    m, blobs, meta = build(1, state, codec="none", chunk_bytes=1 << 12)
    for rid in rids:
        src.drop_request(rid)
    dst.import_request_state(assemble(m, blobs, meta))
    rest, done = _drive_group(dst, rids)
    assert done == set(rids)
    _assert_continues(part, rest, full)
    assert dst.n_prefill_tokens == 0
    assert src.alloc.n_free == src.alloc.num_pages - 1
