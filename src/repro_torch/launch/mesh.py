"""Mesh construction on ``torch.distributed``.

Port of ``repro.launch.mesh``: functions, not module-level constants, so
that importing this module touches no process group.  Each builds a
``DeviceMesh`` with ``init_device_mesh`` over the world that
``torch.distributed`` already runs (``torch.distributed.run`` starts one,
or the caller's ``init_process_group``), with the reference's mesh dim
names.  The meshes are on CUDA devices unless ``device_type="cpu"`` asks
for gloo's CPU ranks.
"""
from __future__ import annotations


def _mesh(shape, names, device_type):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with "
                           "torch.distributed.run or init_process_group")
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of {dict(zip(names, shape))} needs {n} "
                         f"ranks, the world has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """16x16 = 256 ranks per pod; multi_pod adds a leading pod axis (2 pods)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device_type)


def make_local_mesh(data: int = 1, model: int = 1, *, device_type="cuda"):
    """A (data, model) mesh over the whole world, which must hold
    ``data * model`` ranks (the reference shrinks the mesh to the devices
    it finds; the port refuses, ROADMAP queue 3)."""
    return _mesh((data, model), ("data", "model"), device_type)
