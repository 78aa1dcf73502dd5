"""Cost reference: counted FLOPs and bytes of one step, for the roofline
(the port's counterpart of ``repro.core.costref``).

The reference compiles a single-device, unrolled step at a few layer,
batch and seq sizes, reads XLA's ``cost_analysis()`` and recovers the
full-size cost by exact polynomial extrapolation.  PyTorch has no HLO,
so the port counts its own step instead, on ``meta`` tensors (nothing is
allocated), through the plain versions of every kernel (``"ref"``): the
train step (the loss, its backward with remat as the config says, the
clip and AdamW), ``model.prefill_fn`` or ``model.decode_fn`` over the
``init_cache`` cache.  A kernel computes the same function as its plain
version, so the count stands for it; a CUDA kernel called through
ctypes would be invisible to the counters, which is why the count never
runs through ``"auto"`` on a card.

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode``.  It counts the
    matmul-class ops (``mm``, ``bmm``, ``addmm``, attention, convolution)
    and 0 for every elementwise op, where XLA counts both: the count runs
    ~5% below the reference's on the SMOKE configs, a scan whose plain
    version is elementwise (the RG-LRU) adds nothing, and AdamW's ~19
    flops a parameter are left out (whisper's 32,768-row ``pos_dec``
    table makes that a quarter of its SMOKE train step).
  * Bytes: :class:`ByteCounter`, every non-view aten op's inputs and
    outputs summed, each op as if it ran alone: the port's eager step,
    whose ops outside the kernels do run one by one.  The plain versions
    of the kernels (``_KERNEL_PLAIN``) are counted at their kernels'
    byte model instead, each tensor they take read once and each they
    return written once (``ByteCounter.as_kernel``), so the (query, key)
    scores the plain attention materializes, and the per-token states of
    the plain scans, which no kernel writes, are not counted; the copies
    a kernel's wrapper makes to lay its operands out are left out too.
    The count stands in for XLA's "bytes accessed" of the fused
    reference program, and is larger than it, since nothing outside the
    kernels is fused; it also counts every access as one to HBM where
    the card's 50 MB L2 serves some.

The extrapolation is the reference's (:func:`_layer_points`,
:func:`_batch_points`, :func:`_seq_points`, ``fit_poly_and_eval``): the
count is exactly linear in batch, at most quadratic in layers (the
backward of each layer's slice of a stacked parameter writes a
gradient of the whole stack, L of them summed), and quadratic in seq
(the plain attention computes every (query, key) score and masks after,
window or not).  Two differences in the points.  The batch points are 2
and 3, not 1 and 2: at batch 1 some copies are views, off the line.
And the plain
scans (``kernels/rglru_scan/ref.py``, ``kernels/rwkv6_wkv/ref.py``) step
one token at a time, hundreds of meta dispatches a token and layer, so
the hybrid and ssm families count at ``_SCAN_SEQ_POINTS`` and fit,
where the reference counts directly below ``_MAX_DIRECT_SEQ``.  Where
the counted function changes form at the window (a hybrid prefill trims
its cache to the window), the points sit above the window.

Results are cached under ``build/costref_torch/``, keyed by arch,
shape, the whole config and a hash of the port's source, so that a
change to the counted step counts afresh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import importlib
import json
import pathlib
from typing import Dict, List, Tuple
from unittest import mock

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.core.roofline import fit_poly_and_eval
from repro_torch.models import model
from repro_torch.models.config import ModelConfig, ShapeConfig

CACHE_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "costref_torch")

# Above this seq the reference compiles at smaller seqs and extrapolates.
_MAX_DIRECT_SEQ = 8192
# The families whose plain versions loop over the sequence in Python, and
# the seq points they are counted at (a degree-2 fit over three points is
# exact: the scans are linear in seq, the attention quadratic).
_SCAN_FAMILIES = ("hybrid", "ssm")
_SCAN_SEQ_POINTS = (16, 32, 48)


def in_sharding_propagation() -> bool:
    """Whether the op a dispatch mode sees is one DTensor's sharding
    propagation runs on fake tensors to find an output's shape: no rank
    runs it.  (The modes here return ``NotImplemented`` for a DTensor op
    and see the local ops DTensor runs for it, each rank's.)"""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor each non-view aten op reads or
    writes (inputs and outputs, ``empty`` allocations left out): the
    unfused byte count of what runs under it.  A gather counts its whole
    source (an embedding lookup, the table).  A function wrapped by
    :meth:`as_kernel` counts as one op.  A DTensor op counts as the
    local ops this rank runs for it: a rank's bytes on a mesh."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self._in_kernel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if (not self._in_kernel and not func.is_view
                and func.overloadpacket not in _NO_TRAFFIC
                and not in_sharding_propagation()):
            self.bytes += _tensor_bytes((args, kwargs, out))
        return out

    def as_kernel(self, fn):
        """``fn`` counted as the kernel it is the plain version of: the
        tensors it takes and returns, each once, and none of its own
        ops."""
        @functools.wraps(fn)
        def kernel(*args, **kwargs):
            self._in_kernel += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self._in_kernel -= 1
            if not self._in_kernel:
                self.bytes += _tensor_bytes((args, kwargs, out))
            return out
        return kernel


class LocalFlops(TorchDispatchMode):
    """``FlopCounterMode``'s count (its formulas, ``flop_registry``) of
    the ops run under it, a DTensor op as the local ops this rank runs
    for it: a rank's flops on a mesh, FlopCounterMode's total on plain
    tensors."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None and not in_sharding_propagation():
            self.flops += formula(*args, **kwargs, out_val=out)
        return out


_NO_TRAFFIC = (torch.ops.aten.empty, torch.ops.aten.empty_strided,
               torch.ops.aten.empty_like)

# The plain versions of the port's kernels, by the wrapper module that
# calls them, forward and backward: counted at their kernels' bytes.
_KERNEL_PLAIN = {
    "repro_torch.kernels.flash_attention.ops": ("attention_ref",
                                                "attention_bwd_ref"),
    "repro_torch.kernels.moe_gmm.ops": ("moe_gmm_ref", "moe_gmm_bwd_ref"),
    "repro_torch.kernels.paged_attention.ops": ("paged_attention_ref",),
    "repro_torch.kernels.rglru_scan.ops": ("rglru_scan_ref",
                                           "rglru_scan_bwd_ref"),
    "repro_torch.kernels.rwkv6_wkv.ops": ("rwkv6_wkv_ref",
                                          "rwkv6_wkv_bwd_ref"),
}


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


@contextlib.contextmanager
def kernel_bytes(counter: ByteCounter):
    """While open, the kernel wrappers' plain versions count in
    ``counter`` at their kernels' byte model (``_KERNEL_PLAIN``)."""
    with contextlib.ExitStack() as stack:
        for mod_name, names in _KERNEL_PLAIN.items():
            mod = importlib.import_module(mod_name)
            for name in names:
                stack.enter_context(mock.patch.object(
                    mod, name, counter.as_kernel(getattr(mod, name))))
        yield counter


def _unrolled(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """``cfg`` at ``n_layers`` (the decoder's and, for enc-dec, the
    encoder's); the port's stacks are Python loops, always unrolled."""
    kw = dict(num_layers=n_layers)
    if cfg.family == "encdec":
        kw["encoder_layers"] = n_layers
    return dataclasses.replace(cfg, **kw)


def _layer_points(cfg: ModelConfig) -> List[int]:
    """Layer counts for the reference counts (the reference's)."""
    if cfg.family == "hybrid" and cfg.attn_every > 1:
        pts = [cfg.attn_every * k for k in (1, 2, 3)]
    elif cfg.first_k_dense > 0:
        pts = [cfg.first_k_dense + k for k in (2, 4, 6)]
    else:
        pts = [2, 4, 6]
    if cfg.num_layers <= pts[-1]:
        return [cfg.num_layers]
    return pts


def count_cost(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[float, float]:
    """(flops, bytes) of one step of ``shape.kind`` at ``shape``'s batch
    and seq, counted on ``meta`` tensors through the plain versions, the
    kernels' at their kernels' bytes."""
    from repro_torch.launch.strategy import (abstract_train_state,
                                             make_train_step)
    from repro_torch.optim import AdamWConfig

    specs = model.input_specs(cfg, shape)
    if shape.kind == "train":
        fn = make_train_step(cfg, AdamWConfig(), attn_impl="ref",
                             gmm_impl="ref", scan_impl="ref")
        args = (abstract_train_state(cfg), specs)
    elif shape.kind == "prefill":
        fn = model.prefill_fn(cfg, 0, attn_impl="ref", gmm_impl="ref",
                              scan_impl="ref")
        args = (model.abstract_params(cfg), specs)
    else:
        fn = model.decode_fn(cfg, attn_impl="ref", gmm_impl="ref")
        args = (model.abstract_params(cfg), specs["token"], specs["cache"])
    flops, nbytes = FlopCounterMode(display=False), ByteCounter()
    with (torch.set_grad_enabled(shape.kind == "train"), flops, nbytes,
          kernel_bytes(nbytes)):
        fn(*args)
    return float(flops.get_total_flops()), float(nbytes.bytes)


def _seq_points(cfg: ModelConfig, shape: ShapeConfig) -> List[int]:
    """Seq sizes for the reference counts: the reference's, but the scan
    families' (module note)."""
    target = shape.seq_len
    if shape.kind == "decode":
        # decode cost is linear in cache depth; the graph is tiny, so
        # count at the real depth directly.
        return [target]
    if cfg.family in _SCAN_FAMILIES:
        w = cfg.attention_window
        lo = w if shape.kind == "prefill" and 0 < w < target else 0
        pts = [lo + p for p in _SCAN_SEQ_POINTS]
        return [target] if target <= pts[-1] else pts
    if target <= _MAX_DIRECT_SEQ:
        return [target]
    floor = (cfg.attention_window + cfg.attn_chunk + cfg.attn_chunk
             if cfg.attention_window else 2 * cfg.attn_chunk)
    base = max(floor, 2048)
    pts = [base, base + 2048, base + 4096]
    return [min(p, target) for p in pts]


def _batch_points(cfg: ModelConfig, shape: ShapeConfig) -> List[int]:
    """Batch sizes for the reference counts: the target itself up to 2,
    else 2 and 3 (the reference counts at 1 and 2, but at batch 1 some
    of the port's copies are views, so its byte count leaves the line
    the larger batches lie on); a train step split into ``microbatches``
    counts at whole multiples of them."""
    mb = max(1, cfg.microbatches) if shape.kind == "train" else 1
    rows = shape.global_batch // mb
    return [rows * mb] if rows <= 2 else [2 * mb, 3 * mb]


@functools.lru_cache(maxsize=1)
def _source_hash() -> str:
    """Hash of the port's Python source, the counted step's code."""
    root = pathlib.Path(__file__).resolve().parents[1]
    h = hashlib.sha1()
    for f in sorted(root.rglob("*.py")):
        h.update(f.relative_to(root).as_posix().encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def _cache_key(cfg: ModelConfig, shape: ShapeConfig) -> str:
    blob = json.dumps({"cfg": repr(cfg), "shape": repr(shape),
                       "torch": torch.__version__, "src": _source_hash()},
                      sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def cost_reference(cfg: ModelConfig, shape: ShapeConfig,
                   use_cache: bool = True) -> Dict[str, object]:
    """Extrapolated full-size (flops, bytes) of one cell: {"arch",
    "shape", "flops", "bytes", "ref_points": {"l{L}_s{S}_b{B}": (flops,
    bytes)}, "count_s"}, ``count_s`` the seconds the counts took."""
    import time

    cache_file = (CACHE_DIR / f"{cfg.name}__{shape.name}__"
                  f"{_cache_key(cfg, shape)}.json")
    if use_cache and cache_file.exists():
        return json.loads(cache_file.read_text())

    t0 = time.perf_counter()
    seqs = _seq_points(cfg, shape)
    batches = _batch_points(cfg, shape)
    layer_pts = _layer_points(cfg)

    # grid of small reference counts: (layers, seq, batch)
    grid: Dict[Tuple[int, int, int], Tuple[float, float]] = {}
    for lp in layer_pts:
        ucfg = _unrolled(cfg, lp)
        for s in seqs:
            for b in batches:
                sub = ShapeConfig(shape.name, shape.kind, s, b)
                grid[(lp, s, b)] = count_cost(ucfg, sub)

    target_layers = cfg.num_layers

    def at_layers(s: int, b: int, idx: int) -> float:
        """Degree-2 fit over layer points (exact; see module docstring)."""
        if len(layer_pts) == 1:
            return grid[(layer_pts[0], s, b)][idx]
        return fit_poly_and_eval(layer_pts,
                                 [grid[(lp, s, b)][idx] for lp in layer_pts],
                                 target_layers)

    def at_batch(s: int, target_b: int, idx: int) -> float:
        if len(batches) == 1:
            return at_layers(s, batches[0], idx) * target_b / batches[0]
        c1 = at_layers(s, batches[0], idx)
        c2 = at_layers(s, batches[1], idx)
        slope = (c2 - c1) / (batches[1] - batches[0])
        return (c1 - slope * batches[0]) + slope * target_b

    tb = shape.global_batch
    if len(seqs) == 1:
        flops = at_batch(seqs[0], tb, 0)
        bytes_ = at_batch(seqs[0], tb, 1)
    else:
        flops = fit_poly_and_eval(seqs, [at_batch(s, tb, 0) for s in seqs],
                                  shape.seq_len)
        bytes_ = fit_poly_and_eval(seqs, [at_batch(s, tb, 1) for s in seqs],
                                   shape.seq_len)

    out = {
        "arch": cfg.name, "shape": shape.name,
        "flops": flops, "bytes": bytes_,
        "ref_points": {f"l{lp}_s{s}_b{b}": list(grid[(lp, s, b)])
                       for lp in layer_pts for s in seqs for b in batches},
        "count_s": time.perf_counter() - t0,
    }
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    cache_file.write_text(json.dumps(out, indent=1))
    return out
