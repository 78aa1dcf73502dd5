"""Process groups and device meshes (the port's ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names: ``("data", "model")``, or ``("pod", "data",
"model")``.  Its ranks are the processes of the default process group,
which :func:`init_distributed` starts: NCCL for CUDA (the default), gloo
only when the caller asks for the CPU.  The rendezvous is a file store
(``file://`` init method), so concurrent runs on one host never race for
a port and a single-card run opens no socket.  Nothing here falls back
from the card to the host: a CUDA mesh without CUDA raises.

:func:`fake_distributed` starts instead a group on torch's ``fake``
backend (``FakeStore``): this process alone as rank 0 of any world
size, whose collectives move nothing.  A mesh over it is what the dry
run (``repro_torch.launch.dryrun``) lowers a cell on; its device type is
"cuda" by default, the plan a card would issue, with no card touched.
"""
from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def fake_distributed(world_size: int):
    """The default process group on the ``fake`` backend, this process
    its rank 0 of ``world_size``, for the ``with`` block; destroyed on
    leaving it.  Refuses (``RuntimeError``) where a group already runs:
    a fake group cannot share its process with a real one."""
    if dist.is_initialized():
        raise RuntimeError(
            f"a {dist.get_backend()} process group already runs in this "
            f"process; a fake group cannot share it")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    _forget_sharding_decisions()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        _forget_sharding_decisions()


def _forget_sharding_decisions() -> None:
    """Give DTensor an empty cache of sharding decisions.  It is keyed by
    mesh equality, which ignores the process group, so a mesh over a new
    group, equal to one over a destroyed group, would be handed specs
    that name the destroyed group's communicators.  The cache is one per
    thread (autograd's backward thread has its own), so it is replaced,
    not cleared; newer torch keeps one in C++ beside it."""
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator
    prop.propagate_op_sharding = type(prop.propagate_op_sharding)(
        prop.propagate_op_sharding_non_cached)
    clear = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                    None)
    if clear is not None:
        clear()


def _mesh(shape, names, device) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("start the process group first "
                           "(repro_torch.launch.mesh.init_distributed)")
    backend = dist.get_backend()
    if backend == "fake":
        # no card behind it: the device type only picks the plan
        dev_type = "cuda" if device is None else torch.device(device).type
        return init_device_mesh(dev_type, tuple(shape),
                                mesh_dim_names=names)
    dev = resolve_device(device)
    if backend != BACKENDS[dev.type]:
        raise ValueError(f"a {dev.type} mesh needs the "
                         f"{BACKENDS[dev.type]} backend; the process group "
                         f"runs {backend}")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The reference's production mesh: 16 x 16 ("data", "model"), or 2 x
    16 x 16 with "pod" first; needs a process group of 256 / 512 ranks
    (a fake one: :func:`fake_distributed`)."""
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
