"""The train step of the port: ``repro.launch.strategy``'s single-device
``make_train_step``, ``abstract_train_state`` and ``init_train_state``.

No mesh and no shardings: the step runs on the device its state lies
on.  The reference's sharded variants (``make_ctx``, the shardings,
``jit_*``, ``lower_cell``) wait for the distribution slice (ROADMAP.md,
Queue 1).  The reference jits the step; the port runs it eagerly.

Mixed precision as the reference's: the loss is differentiated with
respect to compute-dtype copies of every fp32 parameter with more than
one dimension (``p.detach().to(compute_dtype).requires_grad_()``, the
leaves autograd differentiates, not fp32 leaves with a cast inside the
graph), so those gradients come out in the compute dtype and
``adamw_apply`` casts them to fp32 against the fp32 master parameters.
With ``cfg.microbatches > 1`` the batch is split along its first dim and
the fp32 gradient and loss sums are divided by the count.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import abstract_params
from repro_torch.optim import AdamWConfig, adamw_apply, adamw_init
from repro_torch.tree import flatten, tree_map, unflatten

PyTree = Any


def value_and_grad(cfg: ModelConfig, attn_impl: str = "auto") -> Callable:
    """f(params, batch) -> (loss, metrics, grads) of the loss at the fp32
    master ``params``, differentiated at their compute-dtype copies (the
    module note): grads is a tree like params, each leaf in its
    differentiated copy's dtype.  loss and metrics are detached."""
    lfn = model.loss_fn(cfg, attn_impl)

    def leaf(p):
        if p.dtype == torch.float32 and p.dim() > 1:
            return p.detach().to(cfg.compute_dtype).requires_grad_()
        return p.detach().requires_grad_()

    def f(params, batch):
        params_c = tree_map(leaf, params)
        leaves, structure = flatten(params_c)
        loss, metrics = lfn(params_c, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                unflatten(structure, grads))

    return f


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig) -> Callable:
    """step(state, batch) -> (new_state, metrics); state {"params",
    "opt"}, metrics {"loss", "xent", "aux", "grad_norm", "lr"} ("xent"
    and "aux" only with one microbatch, as the reference's)."""
    vg = value_and_grad(cfg)
    mb = max(1, cfg.microbatches)

    def train_step(state, batch):
        if mb > 1:
            # gradient accumulation: fp32 grad buffer, one optimizer step
            split = {k: a.reshape(mb, a.shape[0] // mb, *a.shape[1:])
                     for k, a in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(p.shape,
                                                  dtype=torch.float32,
                                                  device=p.device),
                            state["params"])
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=split["tokens"].device)
            for i in range(mb):
                loss, _, grads = vg(state["params"],
                                    {k: a[i] for k, a in split.items()})
                gsum = tree_map(lambda a, g: a + g.float(), gsum, grads)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g / mb, gsum)
            loss = loss_sum / mb
            metrics: Dict[str, torch.Tensor] = {}
        else:
            loss, metrics, grads = vg(state["params"], batch)
        new_p, new_opt, om = adamw_apply(grads, state["opt"],
                                         state["params"], opt_cfg)
        return ({"params": new_p, "opt": new_opt},
                {"loss": loss, **metrics, **om})

    return train_step


def abstract_train_state(cfg: ModelConfig) -> PyTree:
    """The train state's shapes and dtypes as ``meta`` tensors."""
    params = abstract_params(cfg)

    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    return {"params": params,
            "opt": {"m": tree_map(f32, params), "v": tree_map(f32, params),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device=None) -> Dict[str, Any]:
    """Random params (``model.init_params``, drawn on the generator's
    device) and zero AdamW state, on ``device`` (default CUDA)."""
    params = model.init_params(cfg, generator, device)
    return {"params": params, "opt": adamw_init(params)}


def warm_up(cfg: ModelConfig, params: PyTree,
            batch: Dict[str, Any]) -> float:
    """One forward and backward of the loss at ``params`` on ``batch``,
    results thrown away and nothing updated: what makes the step ready
    to run on the device (the first kernel call loads the kernel
    library, building it with nvcc on a cold disk cache).  Waits for the
    device.  Returns the loss as a float."""
    loss, _, grads = value_and_grad(cfg)(params, batch)
    del grads
    return float(loss)
