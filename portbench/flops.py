"""Operations and bytes of the model's work, from its shapes alone, and the
chip's peaks.  Counts run on the host; nothing here reads the device.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates: 989 TFLOP/s
in bf16, 67 TFLOP/s in fp32 outside the tensor cores, 3.35 TB/s of HBM,
at the full 700 W power limit (a run prints the card's limit beside its
numbers).  A bound counts each input byte read once and each output
byte written once, and the operations the algorithm needs; a roofline
share is the bound's time over the measured time.
"""
from __future__ import annotations

import math
from typing import Sequence

from portbench.dims import Dims
from portbench.weights import layout

PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
HBM_BPS = 3.35e12
BF16 = 2


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    return max(flops / peak, nbytes / HBM_BPS)


def n_params(dm: Dims) -> int:
    return sum(math.prod(s) for s, _ in layout(dm).values())


def n_active(dm: Dims) -> int:
    """Parameters a token touches, every leaf counted, the routed
    experts' at top_k / n_experts (the program's ``num_active_params``)."""
    total = 0
    for name, (shape, _) in layout(dm).items():
        n = math.prod(shape)
        if ".experts." in name:
            n = n * dm.top_k // dm.experts
        total += n
    return total


def visible_pairs(s: int) -> int:
    """(query, key) pairs a causal attention over s tokens computes."""
    return s * (s + 1) // 2


def train_model_flops(dm: Dims, b: int, s: int) -> float:
    """Model flops of one train step at b x s: 6 N_active tokens + 12 L b
    hq hd pairs (remat's recomputed forward not counted); the formula
    of ``chip_smoke.py``'s ``train_model_flops`` for these families."""
    return (6.0 * n_active(dm) * b * s
            + 12.0 * b * dm.hq * dm.hd * dm.layers * visible_pairs(s))


def layer_matmul(dm: Dims, moe: bool, active: bool = True) -> int:
    """Weights one token multiplies by in one layer (attention, then the
    MLP, or the router, the shared experts and, with ``active``, its
    top_k routed experts; without, all of them)."""
    d, q, kv = dm.d, dm.hq * dm.hd, dm.hkv * dm.hd
    n = 2 * d * q + 2 * d * kv
    if not moe:
        return n + 3 * d * (dm.ff_dense if dm.moe else dm.ff)
    n += d * dm.experts + 3 * d * dm.shared * dm.ff
    return n + 3 * d * dm.ff * (dm.top_k if active else dm.experts)


def token_matmul(dm: Dims) -> int:
    """Weights one token multiplies by through the stack (no head)."""
    return sum(layer_matmul(dm, i >= dm.first_dense and dm.moe)
               for i in range(dm.layers))


def prefill_flops(dm: Dims, s: int) -> float:
    """A batch-1 prefill of s tokens: the stack over every token, causal
    attention over its pairs, the head at the last position only."""
    return (2.0 * token_matmul(dm) * s
            + 4.0 * dm.hq * dm.hd * visible_pairs(s) * dm.layers
            + 2.0 * dm.d * dm.vocab)


def decode_flops(dm: Dims, lengths: Sequence[int]) -> float:
    """One decode step of the live rows, each attending over its length."""
    return (len(lengths) * (2.0 * token_matmul(dm) + 2.0 * dm.d * dm.vocab)
            + 4.0 * dm.hq * dm.hd * dm.layers * sum(lengths))


def kv_bytes(dm: Dims, tokens: int) -> float:
    """K and V of ``tokens`` positions over every layer, bf16."""
    return 2.0 * dm.layers * dm.hkv * dm.hd * BF16 * tokens


def live_experts(dm: Dims, rows: int) -> float:
    """Experts that ``rows`` tokens routed uniformly at random pick at
    least once, in expectation (each row picks top_k distinct ones)."""
    return dm.experts * (1.0 - (1.0 - dm.top_k / dm.experts) ** rows)


def routed_rows(rows: int, total: int) -> int:
    """Rows the fixed-width decode routes: the live rows, and one for the
    inactive ones, which all carry the same token."""
    return rows + (1 if rows < total else 0)


def decode_weight_bytes(dm: Dims, rows: int, width: int) -> float:
    """Weights one decode step of ``rows`` live rows (of ``width``) reads:
    every layer's attention and MLP, the router and shared experts, the
    routed experts the step is expected to touch, and the head."""
    e_bytes = 3.0 * dm.d * dm.ff * BF16
    total = 0.0
    for i in range(dm.layers):
        moe = i >= dm.first_dense and dm.moe
        total += BF16 * layer_matmul(dm, moe, active=False)
        if moe:
            total -= e_bytes * dm.experts
            total += e_bytes * live_experts(dm, routed_rows(rows, width))
    return total + BF16 * dm.d * dm.vocab


def decode_bound_s(dm: Dims, lengths: Sequence[int], width: int) -> float:
    """The decode step's bound: the larger of its model flops at the bf16
    peak and its weights plus the live rows' KV at the HBM rate."""
    return bound_s(decode_flops(dm, lengths),
                   decode_weight_bytes(dm, len(lengths), width)
                   + kv_bytes(dm, sum(lengths)))

