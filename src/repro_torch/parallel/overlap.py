"""Decomposed collective matmul (the port's ``repro.parallel.overlap``):
y = x @ w with x split on its rows and w on its columns over one mesh
axis.

The plain lowering all-gathers x, then multiplies by the local column
block of w.  :func:`ring_allgather_matmul` walks a ring instead: at each
of the axis's n steps a rank multiplies the row block it holds, filling
those output rows, while that block is sent on to the next rank (a
``batch_isend_irecv`` pair started before the product and waited for
after it), so the transfer of the next block hides behind the product
of this one.  Per-rank compute is the same as the plain lowering's; only
the gather is decomposed.  Each step sends once, as the reference's
``fori_loop`` of ``ppermute`` does: n collective-permutes a call.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from repro_torch.core.collectives import region
from repro_torch.parallel.ctx import run_local


def _product(a, w):
    """a @ w with fp32 sums, in a's dtype."""
    return torch.matmul(a.float(), w.float()).to(a.dtype)


def _on_axis(mesh: DeviceMesh, axis: str, dim: int):
    return tuple(Shard(dim) if n == axis else Replicate()
                 for n in mesh.mesh_dim_names)


def ring_allgather_matmul(x, w, mesh: DeviceMesh, axis: str = "model"):
    """x: DTensor (m, k), rows split over ``axis``; w: DTensor (k, n),
    columns split over it.  Returns (m, n), columns split over
    ``axis``."""
    names = tuple(mesh.mesh_dim_names)
    dim = names.index(axis)
    n_dev = mesh.size(dim)
    idx = mesh.get_local_rank(dim)
    group = mesh.get_group(axis)
    nxt = dist.get_global_rank(group, (idx + 1) % n_dev)
    prv = dist.get_global_rank(group, (idx - 1) % n_dev)

    def local(xs, wl):
        m_loc = xs.shape[0]
        acc = xs.new_zeros((m_loc * n_dev, wl.shape[1]))
        block = xs.contiguous()
        for i in range(n_dev):
            recv = torch.empty_like(block)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, block, nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group)])
            src = (idx - i) % n_dev     # owner of the block held now
            acc[src * m_loc:(src + 1) * m_loc] = _product(block, wl)
            for r in reqs:
                r.wait()
            block = recv
        return acc

    with region("ring_allgather_matmul"):
        return run_local(local, mesh, (x, w),
                         (_on_axis(mesh, axis, 0), _on_axis(mesh, axis, 1)),
                         _on_axis(mesh, axis, 1))


def plain_allgather_matmul(x, w, mesh: DeviceMesh, axis: str = "model"):
    """The plain lowering: x all-gathered, then multiplied by the local
    column block of w; (m, n), columns split over ``axis``."""
    with region("plain_allgather_matmul"):
        xs = x.redistribute(mesh, _on_axis(mesh, axis, 0))
        ws = w.redistribute(mesh, _on_axis(mesh, axis, 1))
        xs = xs.redistribute(mesh, (Replicate(),) * mesh.ndim)
        return run_local(_product, mesh, (xs, ws),
                         ((Replicate(),) * mesh.ndim,
                          _on_axis(mesh, axis, 1)),
                         _on_axis(mesh, axis, 1))
