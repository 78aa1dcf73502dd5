"""Process groups and device meshes (the port's ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names: ``("data", "model")``, or ``("pod", "data",
"model")``.  Its ranks are the processes of the default process group,
which :func:`init_distributed` starts: NCCL for CUDA (the default), gloo
only when the caller asks for the CPU.  The rendezvous is a file store
(``file://`` init method), so concurrent runs on one host never race for
a port and a single-card run opens no socket.  Nothing here falls back
from the card to the host: a CUDA mesh without CUDA raises.
"""
from __future__ import annotations

import os
import pathlib
import time
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# default rendezvous file of a one-process run, beside the kernels' build
_STORE_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dist"


def init_distributed(device=None, init_method: Optional[str] = None, *,
                     rank: int = 0, world_size: int = 1) -> float:
    """Start the default process group for ``device`` (None: CUDA, NCCL;
    "cpu": gloo) as ``rank`` of ``world_size``, rendezvous at
    ``init_method`` (a ``file://`` path; default: a fresh file under
    ``build/dist/``, for one process only).  A CUDA group binds this rank
    to card ``rank % device_count`` and opens its communicator now, not
    at its first collective.  Returns the seconds it took."""
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("the default process group is already started")
    if init_method is None:
        if world_size != 1:
            raise ValueError("give every rank the same init_method "
                             "(file://...) when world_size > 1")
        _STORE_DIR.mkdir(parents=True, exist_ok=True)
        path = _STORE_DIR / f"store-{os.getpid()}-{time.time_ns()}"
        init_method = f"file://{path}"
    t0 = time.perf_counter()
    kw = {}
    if dev.type == "cuda":
        local = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(local)
        kw["device_id"] = local
    dist.init_process_group(BACKENDS[dev.type], init_method=init_method,
                            rank=rank, world_size=world_size, **kw)
    return time.perf_counter() - t0


def _mesh(shape, names, device) -> DeviceMesh:
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("start the process group first "
                           "(repro_torch.launch.mesh.init_distributed)")
    backend = dist.get_backend()
    if backend != BACKENDS[dev.type]:
        raise ValueError(f"a {dev.type} mesh needs the "
                         f"{BACKENDS[dev.type]} backend; the process group "
                         f"runs {backend}")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The reference's production mesh: 16 x 16 ("data", "model"), or 2 x
    16 x 16 with "pod" first; needs a process group of 256 / 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device)


def make_dev_mesh(data: int = 1, model: int = 1, pod: int = 0,
                  device=None) -> DeviceMesh:
    """A small mesh over the process group's ranks (their number must be
    the mesh's size)."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"), device)
    return _mesh((data, model), ("data", "model"), device)


def mesh_chips(mesh: DeviceMesh) -> int:
    return mesh.size()
