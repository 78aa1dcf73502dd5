"""How ``correct`` is decided: the numbers the plain reference reads from
what the timed path produced, each held to its limit
(``limits/<workload>.json``).

Serving: ``logit_gap``, the widest gap by which a served token's logit
lies below the reference's best at its position, over a sample of the
window's finished requests drawn from the seed, the longest among them
(the reference runs one fp32 forward over each prompt and its served
tokens).  The control (``control=True``) reads, at the same positions,
the gap of the token that the reference computed in fp8 puts first.

Training: over the checked steps, ``loss_gap`` (the widest gap between
the program's and the reference's loss at a step), ``grad_gap`` (the
worst leaf's gap between the norms of the first gradient as AdamW got
it, over the larger of the reference leaf's norm and the median
leaf's) and ``change_gap`` (the same of each leaf's change over the
checked steps; leaves whose reference gradient is under a thousandth
of the median leaf's are left out, since AdamW moves them by rounding
alone).
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch

from portbench import traffic, weights

MOVE_SHARE = 1e-3


def compare(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every reading at or under
    its limit; a reading without a limit, or a limit without a reading,
    is not correct."""
    checked = {n: {"value": v, "limit": limits.get(n)}
               for n, v in readings.items()}
    ok = (set(readings) == set(limits)
          and all(v == v and v <= limits[n] for n, v in readings.items()))
    return ok, checked


def serve_readings(reqs: list, tree: dict, dm, ref, seed: int,
                   tokens: int, control: bool = False) -> Dict[str, float]:
    """``logit_gap`` over the sample of finished ``reqs`` (the engine's
    requests: ``prompt`` and ``out_tokens``), or with ``control`` the
    fp8 control's; also ``checked_tokens``, the served tokens read."""
    sample = traffic.check_sample(reqs, seed, tokens)
    worst, n = float("nan"), 0
    for r in sample:
        served = list(r.out_tokens)
        lg = ref.served_logits(tree, r.prompt, served, dm)
        if control:
            pick = ref.served_logits(tree, r.prompt, served, dm,
                                     quant=True).argmax(-1)
        else:
            pick = torch.as_tensor(served, device=lg.device)
        gap = lg.max(-1).values - lg.gather(1, pick[:, None].long())[:, 0]
        g = float(gap.max())
        worst = g if worst != worst else max(worst, g)
        n += len(served)
    return {"logit_gap": worst}, n


def reference_steps(initial: dict, batches: List, dm, ref, opt: dict,
                    quant: bool = False, rows: Optional[int] = None):
    """The reference's checked steps from the initial params: (losses,
    first clipped gradient norm per leaf, change norm per leaf).
    ``rows``: only the batches' first rows (a planted fault)."""
    p0 = weights.flat(initial)
    params = {n: t.detach().float().clone() for n, t in p0.items()}
    dev = next(iter(params.values())).device
    bs = [torch.as_tensor(b[:rows] if rows else b).to(dev) for b in batches]
    losses, first = ref.adamw_steps(params, bs, dm, opt, quant)
    first = {n: float(torch.linalg.vector_norm(g)) for n, g in first.items()}
    change = {n: float(torch.linalg.vector_norm(params[n] - p0[n].float()))
              for n in params}
    return losses, first, change


def _worst(prog: Dict[str, float], refn: Dict[str, float], names) -> float:
    med = statistics.median(refn[n] for n in names)
    return max(abs(prog[n] - refn[n]) / max(refn[n], med, 1e-30)
               for n in names)


def train_readings(prog, ref_out) -> Dict[str, float]:
    """The three numbers from the program's (losses, first gradient norms,
    change norms) and the reference's."""
    pl, pg, pc = prog
    rl, rg, rc = ref_out
    names = sorted(rg)
    med = statistics.median(rg.values())
    moved = [n for n in names if rg[n] >= MOVE_SHARE * med]
    return {"loss_gap": max(abs(a - b) for a, b in zip(pl, rl)),
            "grad_gap": _worst(pg, rg, names),
            "change_gap": _worst(pc, rc, moved)}
