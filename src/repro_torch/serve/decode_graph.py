"""One decode step over static buffers, run as a captured CUDA graph or
called directly: the port's counterpart of the reference's ``jax.jit``
decode (``repro.serve.batched_executor`` compiles its step once and
``repro.serve.jax_executor`` its per-slot step).

The capture, the ``"auto"`` / ``"graph"`` / ``"eager"`` choice, the
counts and the rules a step keeps are ``repro_torch.step_graph``'s, which
the train step shares; here the choice is named ``decode_impl``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.step_graph import WARMUP  # noqa: F401
from repro_torch.step_graph import StepGraph, resolve_impl


def resolve_decode_impl(decode_impl: str, device: torch.device) -> str:
    """"graph" or "eager" for a decode step on ``device``."""
    return resolve_impl(decode_impl, device, "decode_impl")


class DecodeGraph(StepGraph):
    """A decode step's :class:`~repro_torch.step_graph.StepGraph`, its
    choice named ``decode_impl``."""

    def __init__(self, step: Callable[[Dict[str, Any]], None],
                 buffers: Dict[str, Any], device: torch.device,
                 decode_impl: str = "auto",
                 stream: Optional["torch.cuda.Stream"] = None,
                 pool=None):
        super().__init__(step, buffers, device, decode_impl, stream, pool,
                         option="decode_impl")
