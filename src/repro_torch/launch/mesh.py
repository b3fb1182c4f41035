"""Meshes over ``torch.distributed`` — port of the reference's
``launch/mesh.py``.

Functions, not module constants: importing this module touches no device
and no process group. Single pod: 16x16 = 256 devices, axes (data, model).
Multi-pod: 2x16x16 = 512 devices, axes (pod, data, model); the ``pod``
axis carries pure data parallelism.

Every mesh is a named ``DeviceMesh`` over the process group that is
already initialised (``torch.distributed.init_process_group`` with the
address, world size and rank of each process; nothing on a machine tells
a program of a cluster). ``init_single_process`` starts a one-process
group (NCCL on the card, gloo on the CPU) for one-device runs.
"""
from __future__ import annotations

import socket

import torch

__all__ = ["make_production_mesh", "make_host_mesh", "init_single_process",
           "free_port", "mesh_device_type"]


def mesh_device_type(device=None) -> str:
    """'cuda' unless ``device`` is given as something else; without a
    card a CUDA mesh raises."""
    kind = torch.device(device).type if device is not None else "cuda"
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was asked for but no CUDA card is "
                           "available; pass device='cpu'")
    return kind


def _world() -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group (or init_single_process) "
                           "before building a mesh")
    return dist.get_world_size()


def _mesh(shape, names, device):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(mesh_device_type(device), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The 16x16 (data, model) or 2x16x16 (pod, data, model) mesh; the
    world must have 256 or 512 processes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    mesh_device_type(device)
    world = _world()
    if world != need:
        raise RuntimeError(f"the {'x'.join(map(str, shape))} production mesh "
                           f"needs {need} processes, one a device; this "
                           f"group has {world}")
    return _mesh(shape, names, device)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A small (data, model) mesh over the processes of the group: data
    and model are cut to what the world holds, as the reference cuts them
    to its devices."""
    mesh_device_type(device)
    n = _world()
    data = min(data, n)
    model = min(model, n // data)
    if data * model != n:
        raise RuntimeError(f"a ({data}, {model}) mesh does not cover the "
                           f"{n} processes of the group")
    return _mesh((data, model), ("data", "model"), device)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_single_process(device=None):
    """Start a one-process group (rank 0 of 1, ``tcp://localhost``) with
    NCCL for a CUDA device, gloo for the CPU; does nothing if a group
    exists. Returns the backend's name."""
    import torch.distributed as dist
    kind = mesh_device_type(device)
    backend = "nccl" if kind == "cuda" else "gloo"
    if not dist.is_initialized():
        kw = {}
        if kind == "cuda":
            kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group(backend, init_method=f"tcp://localhost:"
                                f"{free_port()}", world_size=1, rank=0, **kw)
    return dist.get_backend()
