"""Device meshes of the multi-device paths (port of ``lvdgs_tpu/parallel/mesh.py``).

The reference runs one controller over a JAX ``Mesh``; the port runs one
process per rank on ``torch.distributed`` and describes the same layout
with a ``DeviceMesh`` of dims ("data", "gauss") over the world's ranks:
cameras and tile rows go over "data", the map's capacity over "gauss".

Backends: NCCL needs one GPU per rank. gloo serves ranks that share a
device (the CPU, or two ranks on one card); the caller names the backend
when it starts the process group (``lvdgs_torch.parallel.launch``).
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DIMS = ("data", "gauss")


def local_rank() -> int:
    """This process's rank on its host: LOCAL_RANK where a launcher set it
    (torchrun, launch.spawn), else the global rank."""
    env = os.environ.get("LOCAL_RANK")
    return int(env) if env is not None else dist.get_rank()


def rank_device(device=None) -> torch.device:
    """This rank's device: cuda:<local rank> by default, else `device`
    ("cuda" alone: the current card). A device that every rank shares (the
    CPU, or one named card) needs gloo: NCCL refuses two ranks on one
    GPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' (with gloo) to run the ranks on the CPU")
        return torch.device("cuda", local_rank())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist.is_initialized() and dist.get_world_size() > 1 and dist.get_backend() != "gloo":
        raise ValueError(f"ranks that share device {dev} need the gloo backend, not {dist.get_backend()}")
    return dev


def make_mesh(n_data: Optional[int] = None, n_gauss: int = 1, device=None) -> DeviceMesh:
    """A (n_data, n_gauss) mesh with dims ("data", "gauss") over the ranks of
    the process group the caller started, in rank order (n_data: the
    world's ranks over n_gauss). Sets this rank's
    CUDA device first (rank_device), so that the mesh neither picks one
    itself nor starts another backend than the group's."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_gauss
    if n_data * n_gauss != world:
        raise ValueError(f"mesh {n_data}x{n_gauss} != {world} ranks")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return DeviceMesh(dev.type, torch.arange(world).reshape(n_data, n_gauss), mesh_dim_names=DIMS)


def dim_size(mesh: DeviceMesh, name: str) -> int:
    """Ranks along mesh dim `name` (1 where the mesh has no such dim)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def dim_rank(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate along mesh dim `name` (0 where it has none)."""
    return mesh.get_local_rank(name) if name in (mesh.mesh_dim_names or ()) else 0


def dim_group(mesh: DeviceMesh, name: str):
    """The process group along mesh dim `name`, whose group ranks are the
    coordinates along it; None where the mesh has no such dim."""
    return mesh.get_group(name) if name in (mesh.mesh_dim_names or ()) else None
