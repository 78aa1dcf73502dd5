"""Small configurations and mixes of the benchmark's cells, for the CPU.

The cells' own files hold the published widths; these keep each cell's
structure (a leading dense layer then MoE layers of shared and routed
experts; a dense GQA stack with a tied head) at sizes a test run holds,
in fp32 so that the program and the plain reference agree to rounding.
The small granite's tied embedding is drawn at 0.09, not 0.02, so that
its logits spread as the full model's do (0.02 x sqrt(4096) ~ 1.3, here
0.09 x sqrt(128) ~ 1.0): the serving limits are logit gaps.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402
import torch  # noqa: E402

from portbench import program, spec  # noqa: E402

MOE = {"hidden_size": 64, "intermediate_size": 128,
       "moe_intermediate_size": 32, "num_hidden_layers": 3,
       "num_attention_heads": 4, "num_key_value_heads": 4,
       "n_routed_experts": 8, "n_shared_experts": 2,
       "num_experts_per_tok": 2, "first_k_dense_replace": 1,
       "norm_topk_prob": False, "rms_norm_eps": 1e-6, "rope_theta": 10000,
       "vocab_size": 128, "tie_word_embeddings": False,
       "capacity_factor": 1.25, "aux_loss_alpha": 0.01,
       "reference": "decoder_lm", "name": "moe-small"}
DENSE = {"hidden_size": 128, "intermediate_size": 256,
         "num_hidden_layers": 4, "num_attention_heads": 8,
         "num_key_value_heads": 2, "rms_norm_eps": 1e-5,
         "rope_theta": 1e7, "vocab_size": 1024, "tie_word_embeddings": True,
         "initializer_range": 0.09, "reference": "decoder_lm",
         "name": "dense-small"}

CELLS = {"deepseek-moe-16b.train-4x2048": MOE,
         "deepseek-moe-16b.serve-chat": MOE,
         "granite-3-8b.serve-docs": DENSE}
TRAFFIC = {"deepseek-moe-16b.train-4x2048": "train-4x2048",
           "deepseek-moe-16b.serve-chat": "chat-ds",
           "granite-3-8b.serve-docs": "docs-backlog"}

SEED = 123456789012


@pytest.fixture(autouse=True)
def fp32_compute(monkeypatch):
    """The program computes in fp32 here, as the reference does."""
    monkeypatch.setattr(program, "COMPUTE_DTYPE", torch.float32)


def small_mix(cell: str) -> dict:
    """The cell's mix at a small size: its kind, process and distributions'
    kinds kept; fp32 so that only rounding separates the two sides."""
    mix = dict(spec.traffic(TRAFFIC[cell]))
    if mix["kind"] == "train":
        mix.update(batch=2, seq=32)
        return mix
    mix.update(prompt_len={"dist": "lognormal", "median": 12, "sigma": 0.5,
                           "min": 4, "max": 24},
               output_len={"dist": "lognormal", "median": 6, "sigma": 0.5,
                           "min": 2, "max": 8},
               engine={"n_slots": 4, "max_len": 32}, param_dtype="float32",
               # every finished token: over a few dozen, whether the fp8
               # control flips a near tie is chance
               check={"served_tokens": 160})
    if mix["arrivals"]["process"] == "stratified":
        mix["arrivals"] = {"process": "stratified", "rate_per_s": 8.0}
    else:
        # more than a window serves, as in the cell, on a fast host too
        mix["arrivals"] = {"process": "backlog", "requests": 4000}
    return mix


def run_small(cell: str, seconds: float = 3.0, traced: bool = False,
              seed: int = SEED) -> dict:
    """One run of the cell at its small size on the CPU, as ``run.py``
    drives it past its look for a card, held to the cell's own limits."""
    from portbench.cell import run_cell

    bench = spec.benchmark()
    kind = "per_layer" if traced else "end_to_end"
    readers = {m["name"]: spec.metric_module(m["name"]).read
               for m in spec.metrics_of(bench, cell, kind)}
    return run_cell(CELLS[cell], small_mix(cell), spec.limits(cell), seed,
                    seconds, traced, "cpu", time.perf_counter(), readers)

