"""Device meshes of the port — port of ``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names. ``make_host_mesh`` spans the ranks of the default
process group (``torchrun``'s, a caller's, or a world of one made here);
``make_production_mesh`` keeps the reference's production shapes and needs
a world of exactly that many ranks.

Importing this module touches no device and no process group: the meshes
are made by functions.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


def init_process_group(device=None) -> None:
    """The default process group, unless there is one: from the
    environment when ``torchrun`` set it (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``), else a world of one rank over an in-memory store.
    NCCL for the card (each rank on card ``LOCAL_RANK``), gloo for the
    CPU."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_host_mesh(model_axis: int | None = None, *,
                   device=None) -> DeviceMesh:
    """A ``(world // m, m)`` mesh named ``("data", "model")`` over every
    rank, m = ``model_axis`` (default 1). ``device=None`` is the card
    (NCCL; raises when no card is visible), ``"cpu"`` the CPU (gloo).
    Raises a ``ValueError`` when m does not divide the world."""
    dev = resolve_device(device)
    init_process_group(dev)
    world = dist.get_world_size()
    m = model_axis or 1
    if world % m:
        raise ValueError(f"model axis {m} does not divide the world of "
                         f"{world} ranks")
    return init_device_mesh(dev.type, (world // m, m),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The reference's production mesh: ``(data=16, model=16)``, or
    ``(pod=2, data=16, model=16)`` with ``multi_pod``. Raises unless the
    world has exactly 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = resolve_device(device)
    init_process_group(dev)
    need = 1
    for s in shape:
        need *= s
    if dist.get_world_size() != need:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs {need} ranks; the world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)
