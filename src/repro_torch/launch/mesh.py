"""Production mesh construction (port of ``repro.launch.mesh``).

Functions, not module-level constants, so importing this module touches no
process group.  Each builds a ``DeviceMesh`` through
``torch.distributed.device_mesh.init_device_mesh`` over the process group
the caller has set up, whose world size must be the mesh's size: the dry
run's fake group of 256 or 512 ranks (``launch.dryrun``), or a real one.
"""

from __future__ import annotations


def _mesh(shape, names, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ("data", "model"); with ``multi_pod`` (2, 16, 16) ("pod",
    "data", "model")."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return _mesh((16, 16), ("data", "model"), device_type)


def make_local_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A (data, model) ("data", "model") mesh over the process group the
    caller has joined, whose world size must be ``data * model`` (the
    sharded trainer's ranks, ``launch.train``)."""
    import torch.distributed as dist
    if dist.get_world_size() != data * model:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"ranks; the group has {dist.get_world_size()}")
    return _mesh((data, model), ("data", "model"), device_type)
