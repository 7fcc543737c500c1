"""The port's engine spans, on the CPU: the port of
``tests/test_obs.py::test_engine_spans_cover_step_swap_and_kv_migration``.

The same tiny qwen2-7b reduction (the reference's ``init_params`` at
``PRNGKey(0)``, carried across with ``params_from_numpy``), the same
ticking clock and the same assertions, on ``repro_torch``'s engine and
tracer.  Request 0 uses ``request_key(0, 1)``: with ``request_key(0, 0)``
the request samples EOS as its second token in both packages and has
finished before the export, which the test asserts as its premise.
"""

import jax
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.data import tokenizer as tok
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs.tracer import Tracer
from repro_torch.rl.sampler import request_key
from repro_torch.serving.engine import InferenceEngine

REDUCED = dict(n_heads=2, n_kv_heads=1, d_model=32, head_dim=16, d_ff=64,
               vocab_size=tok.VOCAB_SIZE)


def test_engine_spans_cover_step_swap_and_kv_migration():
    """The real engine traces on a wall clock: step() brackets decode and
    prefill, swap_weights leaves an instant, and a KV export/import pair
    is spanned on both ends of the migration."""
    jcfg = jax_get_config("qwen2-7b").reduced(**REDUCED)
    cfg = get_config("qwen2-7b").reduced(**REDUCED)
    params = params_from_numpy(
        jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0))),
        cfg, "cpu")
    clock = [0.0]

    def tick():
        clock[0] += 0.25             # deterministic monotone "wall" clock
        return clock[0]

    tr = Tracer(tick)
    kw = dict(max_batch=4, slab_len=64, temperature=1.0, page_size=8,
              tracer=tr, device="cpu")
    src = InferenceEngine(cfg, params, **kw)
    dst = InferenceEngine(cfg, params, **kw)

    prompt = tok.encode("12+34=")
    src.add_request(0, prompt, request_key(0, 1), len(prompt) + 12,
                    len(prompt))
    emitted = []
    for _ in range(3):
        emitted += src.step()
    # premise: the request is still decoding, so there is state to export
    assert [e.req_id for e in emitted] == [0, 0, 0]
    assert not any(e.finished for e in emitted)
    assert src.exportable_request_ids() == [0]
    src.swap_weights(params, version=7)
    state = src.export_request_state([0])
    src.drop_request(0)
    dst.import_request_state(state)
    dst.step()

    spans = tr.spans()
    names = [s.name for s in spans]
    assert names.count("engine.decode") >= 4       # 3 src steps + 1 dst
    assert names.count("engine.prefill") >= 4
    assert "engine.kv_export" in names and "engine.kv_import" in names
    swap = next(s for s in spans if s.name == "engine.swap_weights")
    assert swap.duration == 0.0 and swap.attrs["version"] == 7
    assert set(tr.lanes()) == {"engine"}
    for s in spans:
        assert s.t1 is not None and s.t1 >= s.t0   # well-formed, closed
