"""The train step of the port: ``repro.launch.strategy``'s single-device
``make_train_step``, ``abstract_train_state`` and ``init_train_state``.

No mesh and no shardings: the step runs on the device its state lies
on.  The reference's sharded variants (``make_ctx``, the shardings,
``jit_*``, ``lower_cell``) wait for the distribution slice (ROADMAP.md,
Queue 1).  The reference jits the step with its state donated;
:class:`TrainStep` is the port's counterpart: the step over a static
state and batch, updated in place, one captured CUDA graph on the card.

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

import functools
from typing import Any, Callable, Dict

import torch

from repro_torch.models import model
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.init import abstract_params
from repro_torch.optim import AdamWConfig, adamw_apply, adamw_init
from repro_torch.step_graph import StepGraph
from repro_torch.tree import copy_tree_, flatten, tree_map, unflatten

PyTree = Any


def value_and_grad(cfg: ModelConfig, attn_impl: str = "auto",
                   gmm_impl: str = "auto",
                   scan_impl: str = "auto") -> Callable:
    """f(params, batch) -> (loss, metrics, grads) of the loss at the fp32
    master ``params``, differentiated at their compute-dtype copies (the
    module note): grads is a tree like params, each leaf in its
    differentiated copy's dtype.  loss and metrics are detached.
    ``attn_impl``, ``gmm_impl`` and ``scan_impl`` pick the attention's,
    the MoE experts' and the recurrences' (RG-LRU scan, RWKV-6 WKV)
    implementations (``repro_torch.kernels``), forward and backward."""
    lfn = model.loss_fn(cfg, attn_impl, gmm_impl, scan_impl)

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


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    attn_impl: str = "auto", gmm_impl: str = "auto",
                    scan_impl: str = "auto") -> Callable:
    """step(state, batch) -> (new_state, metrics); state {"params",
    "opt"}, batch ``model.input_specs``'s (tokens, and the enc-dec
    family's frames or the vlm's patches; with ``cfg.microbatches > 1``
    every key is split along its first dim), metrics {"loss", the loss's
    own ("xent", and "aux" but for the enc-dec family), "grad_norm",
    "lr"} (the loss's own only with one microbatch, as the
    reference's).  The ``*_impl`` choices are :func:`value_and_grad`'s."""
    vg = value_and_grad(cfg, attn_impl, gmm_impl, scan_impl)
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


def _step_in_place(step: Callable, bufs: Dict[str, Any]) -> None:
    """``step`` over ``bufs["state"]`` and ``bufs["batch"]``, its new
    state copied over the old and its metrics into ``bufs["metrics"]``."""
    new_state, metrics = step(bufs["state"], bufs["batch"])
    copy_tree_(bufs["state"], new_state, "train state")
    out = bufs["metrics"]
    for k, v in metrics.items():
        if k not in out:        # the first call: a warm-up, never captured
            out[k] = torch.empty_like(v)
        out[k].copy_(v)


class TrainStep:
    """The train step as the reference compiles it
    (``jax.jit(step_fn, donate_argnums=(0,))``, compiled ahead of time):
    :func:`make_train_step`'s step over a static train state and a static
    batch of ``model.input_specs``'s (batch, seq) training shape on
    ``state``'s device (tokens; the enc-dec family's also ``frames``, the
    vlm's ``patches`` and seq - num_patches tokens), run as one captured
    CUDA graph (the forward, remat's recompute and the backward with the
    flash, grouped-matmul, RG-LRU scan and WKV kernels, the global-norm
    clip and the AdamW update) or called directly.  ``step_impl`` is
    ``repro_torch.step_graph``'s choice: "auto" (the graph on CUDA, a
    direct call on the CPU), "graph" or "eager".

    Each step writes the new state over the old, in place, with the
    values :func:`make_train_step` returns (its arithmetic, copied into
    the static tensors): ``self.state`` holds the params, ``opt``'s m, v
    and step; ``self.metrics`` the step's loss, xent and aux (aux not for
    the enc-dec family; both with one microbatch only, as the
    reference's), grad_norm and lr, fp32 scalars on the device that a
    caller reads after the call.

    Construction is the step's "compile": warm-up calls (``WARMUP`` and
    the capture on the graph path, one direct call on the eager one,
    which loads the kernels), each a whole step on a zero batch that
    advances the state; then :meth:`load_state` puts ``state``'s values
    back.  The step runs on ``device`` (default: where ``state`` lies);
    a ``state`` held on the host is copied over, so a caller whose
    state would not fit on the card beside the step's keeps it there."""

    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig,
                 state: PyTree, batch: int, seq: int,
                 step_impl: str = "auto", device=None):
        device = (torch.device(device) if device is not None
                  else flatten(state)[0][0].device)
        self.state = tree_map(lambda t: t.detach().to(device, copy=True),
                              state)
        self.batch = model.input_specs(
            cfg, ShapeConfig("train", "train", seq, batch), abstract=False,
            device=device)
        self.metrics: Dict[str, torch.Tensor] = {}
        # the step holds no reference to self: a TrainStep is freed, its
        # graph's memory pool with it, as soon as its last user drops it
        self.graph = StepGraph(
            functools.partial(_step_in_place, make_train_step(cfg, opt_cfg)),
            {"state": self.state, "batch": self.batch,
             "metrics": self.metrics},
            device, step_impl, option="step_impl")
        if self.graph.mode == "eager":
            self.graph()
        self.load_state(state)

    def load_state(self, state: PyTree) -> None:
        """Copy ``state`` into the static state; raises ``ValueError``,
        copying nothing, where its keys, or a leaf's shape or dtype,
        differ."""
        copy_tree_(self.state, state, "train state")

    def __call__(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` (host or device tensors of the static
        batch's keys, shapes and dtypes, copied in; any other batch is
        refused with ``ValueError``, a tokens-only one for the enc-dec or
        vlm family included); returns ``self.metrics``."""
        copy_tree_(self.batch, batch, "batch")
        self.graph()
        return self.metrics
