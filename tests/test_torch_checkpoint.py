"""The port's trainer checkpoints: the cases of ``tests/test_checkpoint.py``
(roundtrip, resume continues, latest and retention, a kill mid-write,
orphans) on ``repro_torch.checkpoint``, plus bf16 leaves stored as raw
16-bit words and keys equal to the reference's."""

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.rl import grpo as jax_grpo
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import tree_leaves
from repro_torch.rl import grpo

_TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16,
             d_ff=64, vocab_size=64)


def _tiny_state(dtype="float32"):
    cfg = get_config("qwen2-7b").reduced(dtype=dtype, **_TINY)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, grpo.init_train_state(params, "cpu")


def _equal(a, b):
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roundtrip(tmp_path, dtype):
    cfg, state = _tiny_state(dtype)
    ckpt.save(str(tmp_path / "step_00000003"), state, step=3,
              meta={"t_seed": 12.5})
    restored, side = ckpt.restore(str(tmp_path / "step_00000003"), state)
    assert side["step"] == 3
    assert side["meta"]["t_seed"] == 12.5
    assert _equal(state, restored)
    with np.load(tmp_path / "step_00000003.npz") as data:
        embed = data["['params']['embed']"]
    assert embed.dtype == (np.int16 if dtype == "bfloat16" else np.float32)


def test_keys_equal_the_reference_checkpoint(tmp_path):
    """The archive's keys are the ones the reference's checkpoint writes
    for the same train state."""
    jcfg = jax_get_config("qwen2-7b").reduced(**_TINY)
    jax_ckpt.save(str(tmp_path / "ref"), jax_grpo.init_train_state(
        jax_init_params(jcfg, jax.random.PRNGKey(0))), step=1)
    _, state = _tiny_state()
    ckpt.save(str(tmp_path / "port"), state, step=1)
    with np.load(tmp_path / "ref.npz") as a, np.load(tmp_path / "port.npz") \
            as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape, k


def test_resume_after_training_continues(tmp_path):
    """Simulated trainer crash: restore + one more step == uninterrupted.
    The optimizer updates its state in place, so the uninterrupted run
    goes on from a copy made through the same checkpoint."""
    cfg, state = _tiny_state()
    step = grpo.make_train_step(cfg, lr=1e-3)
    rs = np.random.RandomState(1)
    batch = {
        "tokens": torch.from_numpy(rs.randint(3, 60, (2, 16))
                                   .astype(np.int32)),
        "response_mask": torch.ones(2, 16),
        "advantages": torch.tensor([1.0, -1.0]),
        "behavior_logprobs": torch.zeros(2, 16) - 2.0,
    }
    s1, _ = step(state, batch)
    ckpt.save(str(tmp_path / "step_00000001"), s1, step=1)
    restored, _ = ckpt.restore(str(tmp_path / "step_00000001"), s1)
    assert _equal(s1, restored)
    s2, _ = step(s1, batch)                       # uninterrupted
    s2b, _ = step(restored, batch)                # after restart
    assert _equal(s2, s2b)


def test_latest_step_and_gc(tmp_path):
    cfg, state = _tiny_state()
    ck = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save(state["params"], step=s, block=True)
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert len(list(tmp_path.glob("step_*.json"))) == 2  # gc'd to keep


def test_async_save_snapshots_before_returning(tmp_path):
    """The state may change in place right after ``save`` returns; the
    checkpoint holds the values it had at the call."""
    cfg, state = _tiny_state()
    want = {k: v.clone() for k, v in state["params"]["groups"]["sub0"]
            ["mlp"].items()}
    ck = ckpt.AsyncCheckpointer(str(tmp_path))
    ck.save(state["params"], step=1)
    for v in state["params"]["groups"]["sub0"]["mlp"].values():
        v.add_(1.0)
    ck.wait()
    restored, _ = ckpt.restore(ckpt.step_path(str(tmp_path), 1),
                               state["params"])
    assert all(torch.equal(restored["groups"]["sub0"]["mlp"][k], v)
               for k, v in want.items())


# --------------------------------------------------------------------------- #
# crash semantics
# --------------------------------------------------------------------------- #
def test_kill_mid_write_never_exposes_torn_archive(tmp_path, monkeypatch):
    """A writer dying inside np.savez leaves bytes only under the tmp name:
    no torn ``step_*`` archive is visible and the prior checkpoint stays
    loadable."""
    cfg, state = _tiny_state()
    ckpt.save(str(tmp_path / "step_00000001"), state["params"], step=1)

    real_savez = np.savez

    def dying_savez(path, **arrs):
        real_savez(path, **arrs)           # tmp bytes hit the disk...
        raise KeyboardInterrupt("kill -9")  # ...and the process dies here

    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save(str(tmp_path / "step_00000002"), state["params"], step=2)
    monkeypatch.setattr(np, "savez", real_savez)
    assert not (tmp_path / "step_00000002.npz").exists()
    assert not (tmp_path / "step_00000002.json").exists()
    assert list(tmp_path.glob("*.tmp.npz"))
    assert ckpt.latest_step(str(tmp_path)) == 1
    _, side = ckpt.restore(str(tmp_path / "step_00000001"), state["params"])
    assert side["step"] == 1


def test_orphaned_tmp_files_cleaned_on_startup(tmp_path):
    (tmp_path / "step_00000009.tmp.npz").write_bytes(b"half a checkpoint")
    (tmp_path / "step_00000009.tmp.json").write_text("{")
    ck = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    assert ck.n_orphans_cleaned == 2
    assert not list(tmp_path.glob("*.tmp.*"))
    assert ckpt.clean_orphans(str(tmp_path)) == 0
    assert ckpt.clean_orphans(str(tmp_path / "nope")) == 0


def test_retention_prunes_oldest_first(tmp_path):
    cfg, state = _tiny_state()
    ck = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(state["params"], step=s, block=True)
    live = sorted(int(f.stem.split("_")[1])
                  for f in tmp_path.glob("step_*.json"))
    assert live == [3, 4]
    for s in (3, 4):
        _, side = ckpt.restore(ckpt.step_path(str(tmp_path), s),
                               state["params"])
        assert side["step"] == s
