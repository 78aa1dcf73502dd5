"""The train step of the port: ``repro.launch.strategy``'s
``make_train_step``, ``abstract_train_state``, ``init_train_state``, and
on a mesh ``make_ctx``, ``train_state_shardings`` and the sharded step.

The reference jits the step with its state donated; :class:`TrainStep`
is the port's counterpart on one device: the step over a static state
and batch, updated in place, one captured CUDA graph on the card.
:class:`ShardedTrainStep` is the counterpart of ``jit_train_step`` on a
``DeviceMesh``: the state's leaves are DTensors placed by the rule table
(``repro_torch.parallel.sharding``), the batch is split by
``batch_placements``, and the step runs under the mesh's
:class:`~repro_torch.parallel.ctx.ParallelCtx`, also captured as one
CUDA graph (its NCCL collectives included).  :class:`ShardedPrefillStep`
and :class:`ShardedDecodeStep` are ``jit_prefill_step`` and
``jit_decode_step``, built the same way: DTensor params by the rule
table, the prompt batch and the token by ``batch_placements``, the
decode cache by ``cache_placements`` (the KV's sequence, or the hybrid's
window slots, split over model, the decode attention's softmax split
with it: ``repro_torch.models.attention``; recurrent states, whisper's
encoder states, positions and rings on the batch only).  The three
sharded steps run all six families: the recurrences on each rank's
channels or heads (``repro_torch.models.rglru``, ``rwkv``), whisper's
encoder, self- and cross-attention on each rank's heads
(``repro_torch.models.whisper``), the vlm's patches split with its
tokens' batch.

:func:`lower_cell` is the reference's ``lower_cell``: one cell's step
function, the one each sharded step runs, over its arguments as
``meta`` DTensors on a mesh (each rank's block only, nothing allocated:
the dry run's ``repro_torch.launch.dryrun`` runs it on a fake process
group), and the cell's :class:`ParallelCtx`.

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
import gc
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.collectives import CollectiveCounter, region
from repro_torch.models import model
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.init import abstract_params
from repro_torch.optim import AdamWConfig, adamw_apply, adamw_init
from repro_torch.parallel import sharding as shlib
from repro_torch.parallel.ctx import ParallelCtx, parallel_ctx
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


def make_ctx(cfg: ModelConfig, mesh: DeviceMesh) -> ParallelCtx:
    return ParallelCtx(
        mesh,
        dp_axes=("pod", "data"),
        tp_axis="model",
        sp_axis="model" if cfg.seq_shard_activations else None,
        bf16_grad=cfg.bf16_grad_reduce,
    )


def constrain_grads(cfg: ModelConfig, grads: PyTree,
                    params: PyTree) -> PyTree:
    """Each DTensor gradient redistributed to its parameter's placements
    (the data-parallel reduction: an all-reduce or reduce-scatter of the
    per-rank partial gradients): while still in the compute dtype with
    ``cfg.bf16_grad_reduce`` (the reference's ``constrain_grads``, a bf16
    reduction), else cast to fp32 first, where the reference's XLA
    reduces.  Plain tensors, and gradients already placed as their
    parameters (nothing to reduce), are returned as they are."""
    def one(g, p):
        if not isinstance(g, DTensor) or tuple(g.placements) == tuple(
                p.placements):
            return g
        if not cfg.bf16_grad_reduce:
            g = g.float()
        return g.redistribute(p.device_mesh, p.placements)

    with region("grad_reduce"):
        return tree_map(one, grads, params)


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
            gsum = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), state["params"])
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=split["tokens"].device)
            for i in range(mb):
                loss, _, grads = vg(state["params"],
                                    {k: a[i] for k, a in split.items()})
                grads = constrain_grads(cfg, grads, state["params"])
                gsum = tree_map(lambda a, g: a + g.float(), gsum, grads)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g / mb, gsum)
            loss = loss_sum / mb
            metrics: Dict[str, torch.Tensor] = {}
        else:
            loss, metrics, grads = vg(state["params"], batch)
            grads = constrain_grads(cfg, grads, state["params"])
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


def train_state_shardings(cfg: ModelConfig, mesh: DeviceMesh,
                          rules=None) -> PyTree:
    """DTensor placements of the train state: params and both moments by
    the rule table, the step replicated."""
    pshard = shlib.param_placements(cfg, mesh, rules)
    return {"params": pshard,
            "opt": {"m": pshard, "v": pshard,
                    "step": (Replicate(),) * mesh.ndim}}


def shard_train_state(state: PyTree, cfg: ModelConfig, mesh: DeviceMesh,
                      rules=None) -> PyTree:
    """A full train state (the same on every rank) -> DTensors on the
    mesh's device, each rank keeping its blocks."""
    dev = _mesh_device(mesh)
    return tree_map(lambda t, plc: shlib.distribute(t, plc, mesh, dev),
                    state, train_state_shardings(cfg, mesh, rules))


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device=None, mesh: Optional[DeviceMesh] = None
                     ) -> Dict[str, Any]:
    """Random params (``model.init_params``, drawn on the generator's
    device) and zero AdamW state, on ``device`` (default CUDA); with a
    ``mesh``, sharded onto it (:func:`shard_train_state`)."""
    params = model.init_params(cfg, generator, device)
    state = {"params": params, "opt": adamw_init(params)}
    if mesh is not None:
        state = shard_train_state(state, cfg, mesh)
    return state


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


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


def _local_metrics(step: Callable) -> Callable:
    """``step`` with its metrics as this rank's plain tensors (each is
    replicated: the local tensor is the whole value)."""
    def run(state, batch):
        new_state, metrics = step(state, batch)
        return new_state, {k: v.to_local() if isinstance(v, DTensor) else v
                           for k, v in metrics.items()}
    return run


def _sharded_step(run: Callable, ctx: ParallelCtx,
                  counters: list, bufs: Dict[str, Any]) -> None:
    """``run(bufs)``, one step in place, under ``ctx``; the first call (a
    warm-up, or the one direct call) also runs under a
    ``CollectiveCounter``, kept in ``counters``."""
    if counters:
        with parallel_ctx(ctx):
            run(bufs)
        return
    counter = CollectiveCounter()
    with parallel_ctx(ctx), counter:
        run(bufs)
    counters.append(counter)
    # the counted call leaves reference cycles that hold a step's tensors
    # (a train state's worth on the card); StepGraph's capture runs with
    # the collector off, so they are collected here
    gc.collect()


def _load(dst: PyTree, src: PyTree, what: str) -> None:
    """Copy ``src`` into the DTensor tree ``dst``: a DTensor leaf of the
    same placements as it is, a full tensor as this rank's block."""
    def local(d, s):
        if isinstance(s, DTensor):
            s = s.redistribute(d.device_mesh, d.placements).to_local()
        else:
            s = shlib.local_slice(s, d.placements, d.device_mesh)
        return s

    copy_tree_(tree_map(lambda d: d.to_local(), dst),
               tree_map(local, dst, src), what)


class ShardedTrainStep:
    """The train step on a mesh (the reference's ``jit_train_step`` with
    its state and batch shardings, called under its ``make_ctx``):
    :func:`make_train_step`'s step over a static DTensor train state
    (``train_state_shardings``) and a static batch of the (batch, seq)
    training shape split by ``batch_placements``, run under the mesh's
    :class:`ParallelCtx` as one captured CUDA graph (``step_impl`` as
    :class:`TrainStep`'s: "auto" is the graph on CUDA, a direct call on
    the CPU).  Every rank constructs it with the same full ``state`` (or
    an already sharded one) and calls it with the same full batch; each
    keeps its blocks.

    ``self.collectives`` is the ``CollectiveCounter`` of the first
    (warm-up) step: every collective one step issues, this rank's.
    ``self.state`` holds this rank's DTensors, ``self.metrics`` the
    step's loss, xent, aux, grad_norm and lr as plain fp32 scalars (the
    whole values, replicated).  Construction warms up and captures as
    :class:`TrainStep` does, then loads ``state`` back."""

    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig,
                 mesh: DeviceMesh, state: PyTree, batch: int, seq: int,
                 step_impl: str = "auto", rules=None):
        device = _mesh_device(mesh)
        self.ctx = make_ctx(cfg, mesh)
        self.state = tree_map(
            lambda t, plc: _static(t, plc, mesh, device), state,
            train_state_shardings(cfg, mesh, rules))
        full = model.input_specs(
            cfg, ShapeConfig("train", "train", seq, batch), abstract=False,
            device=device)
        parts = shlib.batch_placements(full, mesh)
        self.batch = tree_map(
            lambda t, pt: _static(t, shlib.placements(pt, mesh), mesh,
                                  device), full, parts)
        self.metrics: Dict[str, torch.Tensor] = {}
        counters: list = []
        self.graph = StepGraph(
            functools.partial(_sharded_step, functools.partial(
                _step_in_place, _local_metrics(make_train_step(
                    cfg, opt_cfg))), self.ctx, counters),
            {"state": self.state, "batch": self.batch,
             "metrics": self.metrics},
            device, step_impl, option="step_impl")
        if self.graph.mode == "eager":
            self.graph()
        self.collectives = counters[0]
        self.load_state(state)

    def load_state(self, state: PyTree) -> None:
        """Copy ``state`` (full tensors or DTensors) into the static
        state; ``ValueError`` where its keys or a leaf's shape or dtype
        differ."""
        _load(self.state, state, "train state")

    def __call__(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` (the full batch, the same on every rank,
        host or device tensors of the static batch's keys, shapes and
        dtypes); returns ``self.metrics``."""
        _load(self.batch, batch, "batch")
        self.graph()
        return self.metrics


def _static(t, plc, mesh: DeviceMesh, device) -> DTensor:
    """A DTensor of placements ``plc`` on ``device`` holding its own copy
    of this rank's block of ``t`` (a full tensor or a DTensor)."""
    if isinstance(t, DTensor):
        t = t.redistribute(mesh, tuple(plc))
        return DTensor.from_local(t.to_local().detach().clone(), mesh,
                                  tuple(plc), run_check=False,
                                  shape=t.shape, stride=t.stride())
    return shlib.distribute(t, plc, mesh, device)


# ---------------------------------------------------------------------------
# serving: the sharded prefill and decode steps
# ---------------------------------------------------------------------------

def _serving_params(params: PyTree, cfg: ModelConfig, mesh: DeviceMesh,
                    device, rules) -> PyTree:
    """``params`` (full tensors or DTensors) as DTensors by
    ``param_placements`` on ``device``, sharing the caller's memory where
    it can, as a serving step only reads them: a full tensor's block is
    a view of it where it is contiguous on ``device`` (at world size 1,
    with the params on the card, the tensor itself), else a copy; a
    DTensor already so placed is itself."""
    def one(t, plc):
        if isinstance(t, DTensor):
            if tuple(t.placements) == tuple(plc) \
                    and t.to_local().device == device:
                return t
            return _static(t, plc, mesh, device)
        local = shlib.local_slice(t, plc, mesh).detach().to(device)
        return DTensor.from_local(local.contiguous(), mesh, tuple(plc),
                                  run_check=False, shape=t.shape,
                                  stride=t.contiguous().stride())

    return tree_map(one, params, shlib.param_placements(cfg, mesh, rules))


def _whole(t) -> torch.Tensor:
    """A DTensor's whole value on this rank (a plain tensor as it is)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def sharded_prefill_fn(cfg: ModelConfig, mesh: DeviceMesh,
                       max_len: int = 0) -> Callable:
    """f(params, batch) -> (logits, cache): ``model.prefill_fn(cfg,
    max_len)`` with its logits whole on every rank and its cache placed
    by ``cache_placements``, as :class:`ShardedPrefillStep` keeps them."""
    pfn = model.prefill_fn(cfg, max_len)

    def place(t, parts):
        plc = shlib.placements(parts, mesh)
        if isinstance(t, DTensor):
            return t.redistribute(mesh, plc)
        return DTensor.from_local(shlib.local_slice(t, plc, mesh), mesh,
                                  plc, run_check=False, shape=t.shape,
                                  stride=t.stride())

    def step(params, batch):
        logits, cache = pfn(params, batch)
        return _whole(logits), tree_map(
            place, cache, shlib.cache_placements(cfg, cache, mesh))

    return step


def sharded_decode_fn(cfg: ModelConfig) -> Callable:
    """f(params, token, cache) -> logits: ``model.decode_inplace_fn``
    (the cache updated in place, the reference's donated cache) with
    its logits whole on every rank, as :class:`ShardedDecodeStep`
    keeps them."""
    dfn = model.decode_inplace_fn(cfg)
    return lambda params, token, cache: _whole(dfn(params, token, cache))


def _prefill_in_place(step: Callable, bufs: Dict[str, Any]) -> None:
    logits, cache = step(bufs["params"], bufs["batch"])
    bufs["logits"].copy_(logits)
    _load(bufs["cache"], cache, "cache")


def _decode_in_place(step: Callable, bufs: Dict[str, Any]) -> None:
    bufs["logits"].copy_(step(bufs["params"], bufs["token"],
                              bufs["cache"]))


def _placed_cache(cfg: ModelConfig, mesh: DeviceMesh, batch: int,
                  max_len: int, device) -> PyTree:
    """A zero decode cache of ``model.init_cache``'s tree, each leaf a
    DTensor placed by ``cache_placements`` holding its own block."""
    full = model.init_cache(cfg, batch, max_len, device)
    return tree_map(lambda t, pt: _static(t, shlib.placements(pt, mesh),
                                          mesh, device),
                    full, shlib.cache_placements(cfg, full, mesh))


class ShardedPrefillStep:
    """The prefill on a mesh (the reference's ``jit_prefill_step``, called
    under its ``make_ctx``): ``model.prefill_fn(cfg, max_len)`` over the
    params as DTensors by the rule table (sharing the caller's memory
    where it can: :func:`_serving_params`) and a static (batch,
    seq) prompt batch split by ``batch_placements``, run under the
    mesh's :class:`ParallelCtx` as one captured CUDA graph of that shape
    (``step_impl`` as :class:`ShardedTrainStep`'s: "auto" is the graph on
    CUDA, a direct call on the CPU).

    Each call writes ``self.logits``, the last position's whole (b, V)
    fp32 logits on every rank, and ``self.cache``, the decode cache as
    DTensors placed by ``cache_placements`` (the batch over the data
    axes, the cached sequence or window slots over model, recurrent
    states on the batch only), each rank holding its blocks.
    ``self.collectives`` is the first call's ``CollectiveCounter``."""

    def __init__(self, cfg: ModelConfig, mesh: DeviceMesh, params: PyTree,
                 batch: int, seq: int, max_len: int,
                 step_impl: str = "auto", rules=None):
        device = _mesh_device(mesh)
        self.ctx = make_ctx(cfg, mesh)
        self.params = _serving_params(params, cfg, mesh, device, rules)
        full = model.input_specs(
            cfg, ShapeConfig("prefill", "prefill", seq, batch),
            abstract=False, device=device)
        self.batch = tree_map(
            lambda t, pt: _static(t, shlib.placements(pt, mesh), mesh,
                                  device),
            full, shlib.batch_placements(full, mesh))
        self.cache = _placed_cache(cfg, mesh, batch, max_len, device)
        self.logits = torch.zeros((batch, cfg.vocab_size),
                                  dtype=torch.float32, device=device)
        counters: list = []
        self.graph = StepGraph(
            functools.partial(_sharded_step, functools.partial(
                _prefill_in_place, sharded_prefill_fn(cfg, mesh, max_len)),
                self.ctx, counters),
            {"params": self.params, "batch": self.batch,
             "cache": self.cache, "logits": self.logits},
            device, step_impl, option="step_impl")
        if self.graph.mode == "eager":
            self.graph()
        self.collectives = counters[0]
        gc.collect()

    def __call__(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The prefill of ``batch`` (the full prompt batch, the same on
        every rank, of the static batch's keys, shapes and dtypes);
        returns ``self.logits`` (``self.cache`` holds the cache)."""
        _load(self.batch, batch, "batch")
        self.graph()
        return self.logits


class ShardedDecodeStep:
    """The decode step on a mesh (the reference's ``jit_decode_step`` with
    its cache donated): ``model.decode_inplace_fn(cfg)`` over the params
    as DTensors by the rule table (sharing the caller's memory, as
    :class:`ShardedPrefillStep`'s), a static (batch,) token split by
    ``batch_placements`` and a static cache of ``model.init_cache(cfg,
    batch, max_len)``'s tree placed by ``cache_placements``, run under
    the mesh's :class:`ParallelCtx` as one captured CUDA graph, its NCCL
    collectives included.  Every cache leaf, each rank's block of it,
    stays at its address: the new K/V are written in place by the rank
    that holds their slot, new recurrent states copied into each rank's
    block.

    Construction warms up and captures (each call a step that advances
    the cache), then zeroes the cache; :meth:`load_cache` puts a
    prefill's in.  ``self.logits`` holds the whole (b, V) fp32 logits of
    the last step on every rank; ``self.collectives`` the first call's
    ``CollectiveCounter``: every collective one step issues, this
    rank's."""

    def __init__(self, cfg: ModelConfig, mesh: DeviceMesh, params: PyTree,
                 batch: int, max_len: int, step_impl: str = "auto",
                 rules=None):
        device = _mesh_device(mesh)
        self.ctx = make_ctx(cfg, mesh)
        self.params = _serving_params(params, cfg, mesh, device, rules)
        tok = {"token": torch.zeros((batch,), dtype=torch.int32,
                                    device=device)}
        self.token = _static(tok["token"], shlib.placements(
            shlib.batch_placements(tok, mesh)["token"], mesh), mesh, device)
        self.cache = _placed_cache(cfg, mesh, batch, max_len, device)
        self.logits = torch.zeros((batch, cfg.vocab_size),
                                  dtype=torch.float32, device=device)
        counters: list = []
        self.graph = StepGraph(
            functools.partial(_sharded_step, functools.partial(
                _decode_in_place, sharded_decode_fn(cfg)),
                self.ctx, counters),
            {"params": self.params, "token": self.token,
             "cache": self.cache, "logits": self.logits},
            device, step_impl, option="step_impl")
        if self.graph.mode == "eager":
            self.graph()
        self.collectives = counters[0]
        gc.collect()
        for t in flatten(self.cache)[0]:
            t.to_local().zero_()

    def load_cache(self, cache: PyTree) -> None:
        """Copy ``cache`` (full tensors or DTensors, e.g. a
        :class:`ShardedPrefillStep`'s) into the static cache;
        ``ValueError``, copying nothing, where its keys or a leaf's shape
        or dtype differ."""
        _load(self.cache, cache, "cache")

    def __call__(self, token: torch.Tensor) -> torch.Tensor:
        """One step on ``token`` (the full (batch,) int32 tokens, the same
        on every rank); returns ``self.logits``."""
        _load({"token": self.token}, {"token": token}, "token")
        self.graph()
        return self.logits


# ---------------------------------------------------------------------------
# the dry run's lowering: a cell's step over meta DTensors
# ---------------------------------------------------------------------------

def local_block(t: torch.Tensor, plc, mesh: DeviceMesh,
                device="meta") -> DTensor:
    """A DTensor of ``t``'s shape and dtype and placements ``plc`` whose
    local tensor is this rank's block of zeros only, on ``device``
    (``meta``: nothing allocated).  A dim split over n ranks keeps
    ``torch.chunk``'s block, the larger where n does not divide it (as
    XLA pads); no full tensor is made anywhere."""
    shape = list(t.shape)
    for i, p in enumerate(plc):
        if isinstance(p, Shard):
            n, r, size = mesh.size(i), mesh.get_local_rank(i), shape[p.dim]
            c = -(-size // n)
            shape[p.dim] = max(0, min(size, (r + 1) * c) - r * c)
    return DTensor.from_local(torch.zeros(shape, dtype=t.dtype,
                                          device=device),
                              mesh, tuple(plc), run_check=False,
                              shape=t.shape, stride=t.stride())


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: DeviceMesh,
               rules=None, device="meta"):
    """The reference's ``lower_cell``: (step, args, ctx) of one cell, the
    step to be called as ``step(*args)`` under ``parallel_ctx(ctx)``.
    The step is the one each sharded step runs: train,
    :func:`make_train_step` over the state placed by
    :func:`train_state_shardings` and the batch by ``batch_placements``
    (:class:`ShardedTrainStep`); prefill, :func:`sharded_prefill_fn`
    over the params placed by ``param_placements`` and the batch
    (:class:`ShardedPrefillStep`); decode, :func:`sharded_decode_fn`
    over the params, the token and the cache placed by
    ``cache_placements`` (:class:`ShardedDecodeStep`).  Every argument
    leaf is a :func:`local_block` on ``device``."""
    def placed(tree, parts):
        return tree_map(lambda t, pt: local_block(
            t, shlib.placements(pt, mesh), mesh, device), tree, parts)

    specs = model.input_specs(cfg, shape)
    ctx = make_ctx(cfg, mesh)
    if shape.kind == "train":
        state = tree_map(lambda t, plc: local_block(t, plc, mesh, device),
                         abstract_train_state(cfg),
                         train_state_shardings(cfg, mesh, rules))
        batch = placed(specs, shlib.batch_placements(specs, mesh))
        return make_train_step(cfg, AdamWConfig()), (state, batch), ctx
    params = tree_map(lambda t, plc: local_block(t, plc, mesh, device),
                      abstract_params(cfg),
                      shlib.param_placements(cfg, mesh, rules))
    if shape.kind == "prefill":
        batch = placed(specs, shlib.batch_placements(specs, mesh))
        return sharded_prefill_fn(cfg, mesh), (params, batch), ctx
    tok = {"token": specs["token"]}
    token = placed(tok, shlib.batch_placements(tok, mesh))["token"]
    cache = placed(specs["cache"],
                   shlib.cache_placements(cfg, specs["cache"], mesh))
    return sharded_decode_fn(cfg), (params, token, cache), ctx
