"""The port's InferenceEngine against the reference engine, on the CPU.

Both engines get the same weights (the reference's ``init_params`` carried
across with ``params_from_numpy``) and the same requests; greedy token
streams must be equal and logprobs within 1e-4 (f32, sums in another
order).  The reference runs its dense paged path (``use_pallas=False``),
which ``tests/test_ragged_serving.py`` holds equal to its Pallas path.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.rl.harness import tiny_math_config as jax_tiny_math
from repro.rl.sampler import request_key as jax_request_key
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.configs import get_config, tiny_math_config
from repro_torch.data import tokenizer as tok
from repro_torch.models.convert import params_from_numpy
from repro_torch.rl.sampler import request_key
from repro_torch.serving.engine import AdmissionError, InferenceEngine

LP_TOL = 1e-4


def _weights(jcfg, seed=0):
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, jax.tree.map(np.asarray, jparams)


_JCFG = jax_tiny_math()
_CFG = tiny_math_config()
_JPARAMS, _TREE = _weights(_JCFG)
_PARAMS = params_from_numpy(_TREE, _CFG, "cpu")


def _pair(horizon=1, temperature=0.0, jcfg=_JCFG, cfg=_CFG, jparams=None,
          params=None, **kw):
    ekw = dict(max_batch=4, slab_len=32, page_size=8,
               temperature=temperature, horizon=horizon)
    ekw.update(kw)
    jeng = JaxEngine(jcfg, _JPARAMS if jparams is None else jparams,
                     use_pallas=False, **ekw)
    teng = InferenceEngine(cfg, _PARAMS if params is None else params,
                           device="cpu", **ekw)
    return jeng, teng


def _drain(eng, rids, max_steps=400):
    out = {rid: [] for rid in rids}
    done = set()
    for _ in range(max_steps):
        if len(done) == len(rids):
            break
        for e in eng.step():
            out[e.req_id].append((e.token, e.logprob, e.weight_version))
            if e.finished:
                done.add(e.req_id)
    assert len(done) == len(rids), "requests did not finish"
    return out


def _submit(eng, reqs, key_fn):
    for rid, prompt, max_total in reqs:
        eng.add_request(rid, prompt, key_fn(7, rid), max_total, len(prompt))


def _assert_same(out, ref):
    assert out.keys() == ref.keys()
    for rid in ref:
        assert [t for t, _, _ in out[rid]] == [t for t, _, _ in ref[rid]], rid
        np.testing.assert_allclose([lp for _, lp, _ in out[rid]],
                                   [lp for _, lp, _ in ref[rid]],
                                   atol=LP_TOL)
        assert [v for *_, v in out[rid]] == [v for *_, v in ref[rid]], rid


def _run_both(reqs, **kw):
    jeng, teng = _pair(**kw)
    _submit(jeng, reqs, jax_request_key)
    _submit(teng, reqs, request_key)
    rids = [r[0] for r in reqs]
    return jeng, teng, _drain(jeng, rids), _drain(teng, rids)


_REQS = [(1, tok.encode("12+34="), 18), (2, tok.encode("7*8="), 9),
         (3, tok.encode("9-4=5, 3*3="), 30)]


@pytest.mark.parametrize("horizon", [1, 8])
def test_single_requests_match_reference(horizon):
    """Ragged concurrent requests, rows finishing mid-horizon."""
    _, _, ref, out = _run_both(_REQS, horizon=horizon)
    _assert_same(out, ref)


def test_group_sharing_matches_reference():
    """add_group prefills the prompt once; siblings fork it copy-on-write."""
    prompt = tok.encode("12+34=46. 7*8=")
    jeng, teng = _pair(horizon=4)
    for eng, kf in ((jeng, jax_request_key), (teng, request_key)):
        eng.add_group([(10 + j, kf(3, 10 + j), len(prompt) + 12 + 3 * j)
                       for j in range(3)], prompt, len(prompt))
        eng.add_request(20, tok.encode("5+5="), kf(3, 20), 14, 5)
    rids = [10, 11, 12, 20]
    ref, out = _drain(jeng, rids), _drain(teng, rids)
    _assert_same(out, ref)
    assert teng.n_prefills == jeng.n_prefills == 2
    assert teng.n_shared_prompt_tokens == jeng.n_shared_prompt_tokens \
        == 2 * len(prompt)
    assert teng.alloc.n_free == teng.alloc.num_pages - 1


def test_chunked_prefill_mid_page_offsets():
    """Prompts longer than the chunk budget prefill over several steps, the
    later chunks starting mid-page (offsets 11, 22, 33 with 8-token
    pages)."""
    long = [tok.BOS] + [5 + (i * 7) % 40 for i in range(40)]
    reqs = [(1, long, len(long) + 10), (2, tok.encode("3*4="), 12)]
    jeng, teng, ref, out = _run_both(reqs, prefill_chunk=11, horizon=2)
    _assert_same(out, ref)
    assert teng.n_prefill_tokens == jeng.n_prefill_tokens == len(long) + 5


def test_reduced_qwen3_matches_reference():
    """The paper's model family (qk-norm, tied embeddings), reduced."""
    jcfg = jax_get_config("qwen3-8b").reduced(vocab_size=tok.VOCAB_SIZE)
    cfg = get_config("qwen3-8b").reduced(vocab_size=tok.VOCAB_SIZE)
    jparams, tree = _weights(jcfg, seed=3)
    params = params_from_numpy(tree, cfg, "cpu")
    jeng, teng = _pair(horizon=8, jcfg=jcfg, cfg=cfg, jparams=jparams,
                       params=params)
    for eng, kf in ((jeng, jax_request_key), (teng, request_key)):
        _submit(eng, _REQS, kf)
    rids = [r[0] for r in _REQS]
    _assert_same(_drain(teng, rids), _drain(jeng, rids))


def test_swap_weights_version_stamps():
    """A swap between steps: later tokens carry the new version and come
    from the new weights, in both packages alike."""
    jparams2, tree2 = _weights(_JCFG, seed=1)
    params2 = params_from_numpy(tree2, _CFG, "cpu")
    jeng, teng = _pair(horizon=4)
    prompt = tok.encode("1+2=")
    streams = []
    for eng, kf, p2 in ((jeng, jax_request_key, jparams2),
                        (teng, request_key, params2)):
        eng.add_request(1, prompt, kf(0, 1), len(prompt) + 14, len(prompt))
        out = []
        for e in eng.step() + eng.step():      # prefill, one horizon
            out.append((e.token, e.logprob, e.weight_version))
        eng.swap_weights(p2, version=5)
        out.extend(_drain(eng, [1])[1])
        streams.append({1: out})
    _assert_same(streams[1], streams[0])
    versions = [v for *_, v in streams[1][1]]
    assert versions == [0] * 5 + [5] * 9


def test_pool_growth_keeps_streams():
    """A tiny initial pool grows mid-run (in the decode headroom
    reservation and at admission) without changing any token."""
    reqs = [(1, tok.encode("1+2="), 44), (2, tok.encode("12*3="), 40)]
    jeng, teng, ref, out = _run_both(reqs, slab_len=4, page_size=4,
                                     horizon=8, max_batch=2)
    _assert_same(out, ref)
    assert teng.alloc.num_pages > 9, "pool never grew"
    assert teng.cache["k_pages"].shape[1] == teng.alloc.num_pages
    assert teng.alloc.n_free == teng.alloc.num_pages - 1


def test_horizon_matches_h1_at_temperature():
    """(request, position)-keyed sampling: H = 8 emits exactly the tokens
    and logprobs of H = 1 at temperature 1."""
    outs = []
    for H in (1, 8):
        eng = InferenceEngine(_CFG, _PARAMS, max_batch=4, slab_len=32,
                              page_size=8, temperature=1.0, horizon=H,
                              device="cpu")
        _submit(eng, _REQS, request_key)
        outs.append(_drain(eng, [r[0] for r in _REQS]))
    assert outs[0] == outs[1]


def test_admission_errors():
    eng = InferenceEngine(_CFG, _PARAMS, max_batch=1, max_context=32,
                          temperature=0.0, device="cpu")
    prompt = tok.encode("7*8=")
    eng.add_request(1, prompt, request_key(0, 1), 20, len(prompt))
    with pytest.raises(AdmissionError):           # engine full
        eng.add_request(2, prompt, request_key(0, 2), 20, len(prompt))
    eng2 = InferenceEngine(_CFG, _PARAMS, max_batch=2, max_context=32,
                           temperature=0.0, device="cpu")
    with pytest.raises(AdmissionError):           # over max_context
        eng2.add_request(3, prompt, request_key(0, 3), 64, len(prompt))
    capped = InferenceEngine(_CFG, _PARAMS, max_batch=4, slab_len=8,
                             page_size=4, temperature=0.0,
                             max_pool_pages=12, device="cpu")
    capped.add_request(4, prompt, request_key(0, 4), 40, len(prompt))
    with pytest.raises(AdmissionError):           # page commitment cap
        capped.add_request(5, prompt, request_key(0, 5), 40, len(prompt))
    assert capped.free_slots() == 3                # nothing leaked


def test_engine_counters_and_surface():
    eng = InferenceEngine(_CFG, _PARAMS, max_batch=4, slab_len=32,
                          page_size=8, temperature=0.0, horizon=4,
                          device="cpu")
    assert eng.supports_prefix_sharing and eng.free_slots() == 4
    _submit(eng, _REQS, request_key)
    assert eng.free_slots() == 1 and eng.n_active == 0
    _drain(eng, [r[0] for r in _REQS])
    assert eng.n_prefill_dispatches == 1 and eng.n_decode_dispatches >= 3
    assert eng.n_active == 0 and eng.free_slots() == 4
    assert torch.equal(eng._dev_tokens, torch.zeros(4, dtype=torch.int32))


def test_steady_state_decode_uploads_nothing():
    """Scheduler state stays on the device: between admissions and table
    changes, decode dispatches re-use it and upload nothing."""
    eng = InferenceEngine(_CFG, _PARAMS, max_batch=4, slab_len=64,
                          page_size=64, temperature=0.0, horizon=4,
                          device="cpu")
    prompt = tok.encode("12+34=")
    eng.add_request(1, prompt, request_key(0, 1), len(prompt) + 40,
                    len(prompt))
    eng.step()                              # prefill (marks state dirty)
    eng.step()                              # first horizon uploads
    st0, bt0, d0 = (eng.n_state_uploads, eng.n_bt_uploads,
                    eng.n_decode_dispatches)
    for _ in range(4):
        evs = eng.step()
        assert len(evs) == 4 and not any(e.finished for e in evs)
    assert eng.n_decode_dispatches == d0 + 4
    assert (eng.n_state_uploads, eng.n_bt_uploads) == (st0, bt0)
