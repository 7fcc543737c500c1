"""The two sides of the sharded trainer's comparison, each run as its own
process by ``tests/test_torch_mesh*.py`` (not collected by pytest):

  python tests/mesh_ranks.py ref DIR CASE...
      the reference's jitted train step (``repro.rl.grpo``) on an
      Auto-axes (data, model) mesh of 4 host devices;
  python tests/mesh_ranks.py port DIR CASE...
      the port's sharded step (``repro_torch``) on 4 gloo ranks spawned
      here, one process a rank.

A CASE is ``kind:arch:data:model:recipe``.  ``DIR/<arch>/init.npz`` holds
the reference's ``init_params`` (written by the test, carried into the
port with ``params_from_numpy``) and ``DIR/batch<i>.npz`` the numpy
batches (``*`` in a key marks the arch).  Kinds:

  train   two steps from the init params; writes ``<side>.<case>.npz``:
          ``loss`` / ``grad_norm`` / ``moe_aux`` a step and ``p<key>``
          every param after (gathered whole); the port also
          ``ranks_agree``, whether every rank saw the same metrics;
  save    (port) the same, saving the sharded state after step 1 under
          ``DIR/ckpt``;
  resume  (port) the state of ``DIR/ckpt`` restored onto this case's mesh
          (``1:1`` is one process, no mesh), then step 2; writes as train;
  moe     the MoE layer alone (``layer.npz``: its params and x) through
          the ``ep > 1`` dispatch (the reference's ``shard_map``, the
          port's rank-local body): ``out``, ``aux`` and each data shard's
          dropped entries.

Keys of a param tree are the reference's path strings
(``['groups']['sub0']['attn']['wq']``).
"""

import os
import sys
from pathlib import Path

WORLD = 4
LR = 1e-3
STEPS = 2


def parse(case):
    kind, arch, data, model, recipe = case.split(":")
    return kind, arch, int(data), int(model), recipe


def case_name(case):
    return case.replace(":", "_")


def flat(tree, path=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{path}['{k}']"))
        else:
            out[f"{path}['{k}']"] = v
    return out


def unflat(items):
    tree = {}
    for key, v in items.items():
        parts = key[2:-2].split("']['")
        t = tree
        for p in parts[:-1]:
            t = t.setdefault(p, {})
        t[parts[-1]] = v
    return tree


def load(path):
    import numpy as np
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def batches(d, arch):
    """The numpy batches of ``arch``: keys ``<arch>*<name>``."""
    out = []
    for i in range(STEPS):
        b = load(Path(d) / f"batch{i}.npz")
        out.append({k.split("*", 1)[1]: v for k, v in b.items()
                    if k.split("*", 1)[0] == arch})
    return out


# --------------------------------------------------------------------------- #
# the reference
# --------------------------------------------------------------------------- #
def run_ref(d, cases):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count="
                               f"{WORLD}")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.distributed import sharding as shd
    from repro.models import moe
    from repro.rl import grpo

    def mesh_of(data, model):
        # Auto axes: the reference's make_local_mesh builds Explicit ones,
        # under which its train step raises ShardingTypeError
        return jax.make_mesh((data, model), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)

    for case in cases:
        kind, arch, data, model, recipe = parse(case)
        cfg = get_config(arch).reduced()
        mesh = mesh_of(data, model)
        out = {}
        if kind == "moe":
            lay = load(Path(d) / "layer.npz")
            p = jax.tree.map(jnp.asarray, unflat(
                {k[1:]: v for k, v in lay.items() if k.startswith("p")}))
            rt = shd.make_runtime(cfg, mesh, recipe)
            x = jax.device_put(jnp.asarray(lay["x"]), shd.to_named(
                shd.sanitize_spec(jax.sharding.PartitionSpec(
                    rt.data_axes, None, None), lay["x"].shape, mesh), mesh))
            o, aux = jax.jit(lambda p, x: moe.moe_layer(p, x, cfg, rt))(p, x)
            out.update(out=np.asarray(o), aux=np.asarray(aux),
                       drops=ref_drops(moe, cfg, lay["p['router']"],
                                       lay["x"], data))
        else:
            params = jax.tree.map(jnp.asarray, unflat(
                load(Path(d) / arch / "init.npz")))
            S = batches(d, arch)[0]["response_mask" if cfg.is_decoder
                                    else "mask"].shape[1]
            rt = shd.make_runtime(cfg, mesh, recipe, remat=True,
                                  q_block=min(S, 512))
            state = grpo.init_train_state(params)
            pspecs = shd.param_specs(cfg, params, recipe, mesh=mesh)
            state = jax.device_put(state, shd.to_named(
                {"params": pspecs,
                 "opt": shd.opt_specs(cfg, state["opt"], pspecs)}, mesh))
            step = jax.jit(grpo.make_train_step(
                cfg, rt, lr=LR,
                loss_kind="grpo" if cfg.is_decoder else "supervised"))

            def loss(p, b):
                fn = grpo.grpo_loss if cfg.is_decoder else \
                    grpo.supervised_loss
                return fn(p, cfg, rt, b)[0]
            for i, b in enumerate(batches(d, arch)):
                jb = jax.device_put(
                    {k: jnp.asarray(v) for k, v in b.items()},
                    shd.to_named(shd.train_batch_specs(mesh, recipe, b),
                                 mesh))
                if i == 0:
                    # the first gradient marks rounding-noise elements
                    g = jax.jit(jax.grad(loss))(state["params"], jb)
                    out.update({"g" + k: np.asarray(v)
                                for k, v in flat(g).items()})
                state, m = step(state, jb)
                for k in ("loss", "grad_norm", "moe_aux"):
                    if k in m:
                        out.setdefault(k, []).append(float(m[k]))
            out.update({"p" + k: np.asarray(v)
                        for k, v in flat(state["params"]).items()})
        np.savez(Path(d) / f"ref.{case_name(case)}.npz", **out)


def ref_drops(moe, cfg, router, x, data):
    """Dropped (token, choice) entries of each data shard's dispatch, from
    the reference's own routing and tables."""
    import jax.numpy as jnp
    import numpy as np
    drops = []
    for xs in np.split(x, data, axis=0):
        flat_x = jnp.asarray(xs.reshape(-1, xs.shape[-1]))
        T = flat_x.shape[0]
        C = moe._capacity(T, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
        tv, ti, _ = moe._route(flat_x, jnp.asarray(router), cfg.top_k,
                               cfg.n_experts_padded)
        _, w = moe._dispatch_tables(tv, ti, cfg.n_experts_padded, C)
        drops.append(T * cfg.top_k - int((np.asarray(w) > 0).sum()))
    return np.array(drops)


# --------------------------------------------------------------------------- #
# the port
# --------------------------------------------------------------------------- #
def run_port(d, cases):
    import torch.multiprocessing as mp
    from repro_torch.launch.train import free_port
    mp.start_processes(_rank, nprocs=WORLD, join=True, start_method="spawn",
                       args=(d, cases, f"tcp://localhost:{free_port()}"))


def _rank(rank, d, cases, address):
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import init_rank, shard_train_state
    from repro_torch.models import moe
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.rl import grpo

    torch.set_num_threads(1)
    cpu = init_rank(rank, WORLD, "gloo", torch.device("cpu"), address)

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    for case in cases:
        kind, arch, data, model, recipe = parse(case)
        cfg = get_config(arch).reduced()
        out = {}
        if data * model == 1:
            mesh = rt = None
            if rank != 0:
                dist.barrier()
                continue
        else:
            mesh = make_local_mesh(data, model, "cpu")
            rt = shd.make_runtime(cfg, mesh, recipe)
        if kind == "moe":
            lay = load(Path(d) / "layer.npz")
            p = {k[1:]: torch.from_numpy(v) for k, v in lay.items()
                 if k.startswith("p")}
            p = unflat(p)
            # an unstacked layer's rules: a prefix layer's path
            specs = shd.param_specs(cfg, {"prefix": {"0": {"mlp": p}}},
                                    recipe, mesh=mesh)
            p = shd.distribute_state(p, specs["prefix"]["0"]["mlp"], mesh)
            x = torch.from_numpy(lay["x"])
            x = shd.distribute_state({"x": x}, {"x": shd.sanitize_spec(
                shd.P(rt.data_axes), x.shape, mesh)}, mesh)["x"]
            with implicit_replication():
                o, aux = moe.moe_layer(p, x, cfg, rt)
            out.update(out=whole(o).numpy(), aux=whole(aux).numpy(),
                       drops=port_drops(moe, cfg, p, lay["x"], data))
        else:
            params = params_from_numpy(
                unflat(load(Path(d) / arch / "init.npz")), cfg, "cpu")
            if mesh is None:
                state = grpo.init_train_state(params, cpu)
            else:
                state = shard_train_state(cfg, params, recipe, mesh, cpu)
            ckdir = str(Path(d) / "ckpt")
            todo = list(enumerate(batches(d, arch)))
            if kind == "resume":
                state, _ = ckpt.restore(ckpt.step_path(ckdir, 1), state)
                todo = todo[1:]
            step = grpo.make_train_step(cfg, lr=LR, remat=True, rt=rt)
            for i, b in todo:
                b = {k: torch.from_numpy(v) for k, v in b.items()}
                if mesh is not None:
                    b = shd.distribute_state(
                        b, shd.train_batch_specs(mesh, recipe, b), mesh)
                state, m = step(state, b)
                for k in ("loss", "grad_norm", "moe_aux"):
                    if k in m:
                        out.setdefault(k, []).append(float(m[k]))
                if kind == "save" and i == 0:
                    ckpt.save(ckpt.step_path(ckdir, 1), state, step=1)
            out.update({"p" + k: whole(v).detach().float().numpy()
                        for k, v in flat(state["params"]).items()})
        if mesh is not None:
            # every rank's metrics (the aux broadcast, the reduced norm):
            # 1 where all ranks agree exactly
            mine = {k: out[k] for k in ("loss", "grad_norm", "moe_aux",
                                        "aux") if k in out}
            every = [None] * WORLD
            dist.all_gather_object(every, mine)
            out["ranks_agree"] = np.array(all(
                {k: np.asarray(v).tolist() for k, v in e.items()}
                == {k: np.asarray(v).tolist() for k, v in mine.items()}
                for e in every))
        if rank == 0:
            np.savez(Path(d) / f"port.{case_name(case)}.npz", **out)
        if mesh is None:
            dist.barrier()
    dist.destroy_process_group()


def port_drops(moe, cfg, p, x, data):
    """Dropped entries of each data shard's dispatch, from the port's
    routing and slots (a slot past the capacity is the dummy E * C)."""
    import numpy as np
    import torch
    router = p["router"].full_tensor()
    drops = []
    for xs in np.split(x, data, axis=0):
        flat_x = torch.from_numpy(xs.reshape(-1, xs.shape[-1]))
        T = flat_x.shape[0]
        C = moe._capacity(T, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
        _, ti, _ = moe._route(flat_x, router, cfg.top_k,
                              cfg.n_experts_padded)
        slot = moe._slots(ti, cfg.n_experts_padded, C)
        drops.append(int((slot == cfg.n_experts_padded * C).sum()))
    return np.array(drops)


# --------------------------------------------------------------------------- #
# the test side
# --------------------------------------------------------------------------- #
B, S = 4, 40        # S passes the reduced windows of 16
# f32 sums in another order, as in tests/test_torch_train_families.py:
# a metric within 1e-5 of max(|value|, 1); after two Adam steps at lr
# 1e-3, 99% of the param elements within 1e-6 and every one within 1e-4,
# unless its first gradient was rounding noise near Adam's eps (|g| <
# 1e-7, such as a k bias's: the softmax is blind to a shift the same for
# every key): there g / (|g| + eps) is ill-conditioned and the element
# stays within one step, lr (tests/test_torch_moe.py's rule)
REL_TOL = 1e-5
PARAM_MAX, PARAM_TIGHT, PARAM_SHARE = 1e-4, 1e-6, 1e-2
NOISE_GRAD, NOISE_MAX = 1e-7, LR


def numpy_batch(cfg, seed):
    """The launcher's layout drawn with numpy (the families tests'
    ``_batch``): tokens, ragged response masks, advantages and behaviour
    logprobs near the policy's own for a decoder; embeddings for an
    ``embeds`` config; labels under a random mask for the encoder."""
    import numpy as np
    rs = np.random.RandomState(seed)
    b = {}
    if cfg.input_mode == "embeds":
        b["embeds"] = rs.randn(B, S, cfg.d_model).astype(np.float32)
    if cfg.is_decoder:
        mask = np.zeros((B, S), np.float32)
        for i in range(B):
            mask[i, 5 + i:S - i] = 1.0
        b.update(tokens=rs.randint(3, cfg.vocab_size, (B, S))
                 .astype(np.int32), response_mask=mask,
                 advantages=rs.randn(B).astype(np.float32),
                 behavior_logprobs=(-np.log(cfg.vocab_size)
                                    + 0.3 * rs.randn(B, S))
                 .astype(np.float32))
    else:
        b.update(labels=rs.randint(0, cfg.vocab_size, (B, S))
                 .astype(np.int32),
                 mask=(rs.rand(B, S) < 0.6).astype(np.float32))
    return b


def write_inputs(d, archs, seed=3):
    """The reference's init params of each arch (``.reduced()``) and two
    numpy batches, under ``d`` (in the calling process, one device)."""
    import jax
    import numpy as np
    from repro.configs import get_config
    from repro.models import init_params
    bat = [{}, {}]
    for arch in archs:
        cfg = get_config(arch).reduced()
        (Path(d) / arch).mkdir(parents=True, exist_ok=True)
        params = init_params(cfg, jax.random.PRNGKey(seed))
        np.savez(Path(d) / arch / "init.npz",
                 **{k: np.asarray(v) for k, v in flat(params).items()})
        for i in range(STEPS):
            bat[i].update({f"{arch}*{k}": v for k, v in
                           numpy_batch(cfg, 10 + i).items()})
    for i in range(STEPS):
        np.savez(Path(d) / f"batch{i}.npz", **bat[i])


def run_sides(d, ref_cases, port_cases, timeout=600):
    """Both sides at once, each in its own process; raises with a side's
    output when it fails."""
    import subprocess
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, side, str(d), *cases], env=env,
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for side, cases in (("ref", ref_cases),
                                       ("port", port_cases)) if cases]
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        if p.returncode != 0:
            raise RuntimeError(f"{p.args[2]} side failed:\n{out[-6000:]}")


def result(d, side, case):
    return load(Path(d) / f"{side}.{case_name(case)}.npz")


def assert_close_metrics(got, want, keys=("loss", "grad_norm", "moe_aux")):
    import numpy as np
    for k in keys:
        if k in want:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.shape == w.shape, k
            assert (np.abs(g - w) <= REL_TOL * np.maximum(np.abs(w), 1.0)
                    ).all(), (k, g, w)


def assert_ranks_agree(got):
    """The port's ranks all saw the same metrics (a mesh case)."""
    assert bool(got["ranks_agree"])


def assert_close_params(got, want):
    import numpy as np
    keys = sorted(k for k in want if k.startswith("p"))
    assert keys == sorted(k for k in got if k.startswith("p"))
    diffs = np.concatenate([np.abs(got[k].astype(np.float32)
                                   - want[k].astype(np.float32)).ravel()
                            for k in keys])
    # without the reference's gradient (a port-only comparison) every
    # element is held to PARAM_MAX
    noise = np.concatenate([np.abs(want["g" + k[1:]]).ravel() < NOISE_GRAD
                            if "g" + k[1:] in want else
                            np.zeros(want[k].size, bool) for k in keys])
    assert diffs[~noise].max() <= PARAM_MAX, diffs[~noise].max()
    assert diffs.max() <= NOISE_MAX, diffs.max()
    assert (diffs > PARAM_TIGHT).mean() <= PARAM_SHARE


if __name__ == "__main__":
    side, d, *cases = sys.argv[1:]
    {"ref": run_ref, "port": run_port}[side](d, cases)
