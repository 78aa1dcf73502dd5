"""AdamW on nested dicts of tensors: the reference's ``repro.optim.adamw``
(decoupled weight decay, global-norm clipping) with the same arithmetic
in the same order.

Functional, as the reference is: :func:`adamw_apply` returns new
parameter, moment and step tensors and leaves its inputs alone.
Everything stays on the device: nothing reads a value on the host
(no ``.item()``) and nothing is copied from it, so an update never waits
for the card and can be captured in a CUDA graph (the captured train
step, ``launch/strategy.py``).  The
reference's optional gradient compression is not ported (single device).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.tree import flatten, unflatten

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def adamw_init(params: PyTree) -> PyTree:
    """fp32 zero moments shaped like ``params`` and an int32 step of 0,
    on the parameters' device."""
    leaves, structure = flatten(params)

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": unflatten(structure, [zeros(p) for p in leaves]),
            "v": unflatten(structure, [zeros(p) for p in leaves]),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device)}


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted-key order, as the reference's)
    of each leaf's fp32 sum of squares."""
    total = 0
    for g in flatten(tree)[0]:
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def adamw_apply(grads: PyTree, opt_state: PyTree, params: PyTree,
                cfg: AdamWConfig):
    """Returns (new_params, new_opt_state, metrics).  Gradients of any
    float dtype are cast to fp32; each new parameter keeps its dtype."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    lr = cfg.schedule(step) if cfg.schedule is not None else cfg.lr

    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        p32 = p.float()
        p32 = p32 - lr * (delta + cfg.weight_decay * p32)
        return p32.to(p.dtype), m, v

    flat_p, structure = flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, flatten(grads)[0], flatten(opt_state["m"])[0],
        flatten(opt_state["v"])[0])]
    new_p = unflatten(structure, [o[0] for o in out])
    new_m = unflatten(structure, [o[1] for o in out])
    new_v = unflatten(structure, [o[2] for o in out])
    # a float lr is filled on the device: a tensor made from a host value
    # is a host-to-device copy, which a graph capture refuses
    metrics = {"grad_norm": gnorm,
               "lr": (lr.float() if torch.is_tensor(lr) else
                      torch.full((), lr, dtype=torch.float32,
                                 device=gnorm.device))}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics
