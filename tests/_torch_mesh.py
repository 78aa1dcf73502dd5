"""Multi-rank harness of the port's distribution tests (CPU only).

The port's side runs on 4 gloo ranks spawned by ``torch.multiprocessing``
on a (2, 2) ("data", "model") mesh, rendezvous at a file store under the
test's tmp dir; each rank calls a module-level function of the test
module and pickles what it returns.  The reference's side runs in one
subprocess with 4 host devices (``--xla_force_host_platform_device_count``)
on a (2, 2) mesh of ``AxisType.Auto`` axes that the harness builds
itself: the reference's own ``make_dev_mesh`` makes ``Explicit`` axes on
this jax, on which its ``shard_activation`` raises.  A test that needs
another mesh gives the subprocess more host devices (``devices``) and
takes the mesh's from the front.
"""
from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4


def auto_mesh(shape=(2, 2), names=("data", "model")):
    """The reference's 2 x 2 mesh with Auto axes (reference side only),
    or one of ``shape`` over the first of the host devices."""
    import math

    import jax
    from jax.sharding import AxisType

    return jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:math.prod(shape)])


def start_subprocess(module: str, fn: str, out: pathlib.Path,
                     devices: int = WORLD) -> subprocess.Popen:
    """``module.fn(out)`` started in a subprocess with ``devices`` host
    devices; :func:`finish` waits for it."""
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]))
    return subprocess.Popen([sys.executable, "-c",
                             f"import {module} as m; m.{fn}({str(out)!r})"],
                            env=env, cwd=ROOT)


def finish(proc: subprocess.Popen, out: pathlib.Path, timeout: int = 600):
    """Wait for ``proc`` (killed past ``timeout``), check its exit code
    and return what it pickled at ``out``."""
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc:
        raise subprocess.CalledProcessError(rc, proc.args)
    with open(out, "rb") as f:
        return pickle.load(f)


def run_reference(module: str, fn: str, out: pathlib.Path,
                  timeout: int = 600, devices: int = WORLD):
    """``module.fn(out)`` in a subprocess with ``devices`` (4) host
    devices; returns what it pickled at ``out``."""
    return finish(start_subprocess(module, fn, out, devices), out, timeout)


def save(obj, path) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _worker(rank, fn, tmp, args):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_dev_mesh

    torch.set_num_threads(1)
    init_distributed("cpu", f"file://{tmp}/store", rank=rank,
                     world_size=WORLD)
    try:
        mesh = make_dev_mesh(2, 2, device="cpu")
        save(fn(rank, mesh, *args), f"{tmp}/rank{rank}.pkl")
    finally:
        dist.destroy_process_group()


def spawn(fn, tmp: pathlib.Path, *args) -> list:
    """``fn(rank, mesh, *args)`` on 4 gloo ranks; each rank's result."""
    import torch.multiprocessing as mp

    tmp.mkdir(parents=True, exist_ok=True)
    mp.spawn(_worker, args=(fn, str(tmp), args), nprocs=WORLD)
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out
