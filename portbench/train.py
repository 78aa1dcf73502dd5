"""Training cells: the program's captured train step
(``launch/strategy.py`` ``TrainStep``) in a closed loop, one batch of the
seeded token stream copied from the host each step.

Set-up builds the one ``TrainStep`` (its warm-ups and capture), then
drives it through its first ``checked_steps`` steps through the same
call and feed as the window, and keeps what the check compares: each
step's loss, each leaf's first gradient as AdamW got it (worked out from
its first moment after step 1: m / (1 - b1)) and each leaf's change once
the checked steps are done.  The window then runs the same object on.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from portbench import traffic, weights
from portbench.trace import Tracer, label


@dataclasses.dataclass
class Steps:
    seconds: float               # from the window's opening to the last end
    steps: int
    tokens_per_step: int
    spans: List[Tuple[float, float]]   # each step's (start, end)


def _norms(tree: dict) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float()))
            for n, t in weights.flat(tree).items()}


def _state(params: dict) -> dict:
    """A train state of ``params`` and zero AdamW moments and step."""
    def zeros():
        return weights.nest({n: torch.zeros_like(t)
                             for n, t in weights.flat(params).items()})

    dev = next(iter(weights.flat(params).values())).device
    return {"params": params,
            "opt": {"m": zeros(), "v": zeros(),
                    "step": torch.zeros((), dtype=torch.int32, device=dev)}}


class TrainBench:
    def __init__(self, cfg, dims, mix: dict, seed: int, device):
        from repro_torch.launch.strategy import TrainStep
        from repro_torch.optim import AdamWConfig

        self.dims, self.mix = dims, mix
        self.b, self.s = mix["batch"], mix["seq"]
        opt = mix["optimizer"]
        params = weights.make(dims, seed, torch.float32, device)
        self.step = TrainStep(
            cfg, AdamWConfig(lr=opt["lr"], b1=opt["b1"], b2=opt["b2"],
                             eps=opt["eps"],
                             weight_decay=opt["weight_decay"],
                             grad_clip=opt["grad_clip"]),
            _state(params), self.b, self.s, device=device)
        # the initial params stay, for the reference after the window
        self.initial = params
        self.check_steps(seed)

    def check_steps(self, seed: int) -> None:
        """From the initial params, the first steps of ``seed``'s stream,
        keeping what the check compares; the stream then goes on."""
        b1 = self.mix["optimizer"]["b1"]
        self.stream = traffic.train_batches(seed, self.b, self.s,
                                            self.dims.vocab)
        self.losses: List[float] = []
        self.checked = []
        for i in range(self.mix["checked_steps"]):
            batch = next(self.stream)
            self.checked.append(batch)
            m = self.step({"tokens": torch.from_numpy(batch)})
            self.losses.append(float(m["loss"]))
            if i == 0:
                self.first_grad = {
                    n: v / (1.0 - b1)
                    for n, v in _norms(self.step.state["opt"]["m"]).items()}
        p0 = weights.flat(self.initial)
        self.change = {
            n: float(torch.linalg.vector_norm((t - p0[n]).float()))
            for n, t in weights.flat(self.step.state["params"]).items()}

    def reseed(self, seed: int) -> None:
        """Start over from ``seed``'s weights and zero moments, on the same
        step (the calibration's many seeds in one process), written into
        its state in place: a second state would not fit beside it."""
        weights.fill_(self.initial, self.dims, seed)
        state = self.step.state
        with torch.no_grad():
            for n, t in weights.flat(state["params"]).items():
                t.copy_(weights.flat(self.initial)[n])
            for moment in ("m", "v"):
                for t in weights.flat(state["opt"][moment]).values():
                    t.zero_()
            state["opt"]["step"].zero_()
        self.check_steps(seed)

    def run(self, seconds: float, tracer: Optional[Tracer] = None) -> Steps:
        """Steps back to back until one ends at or after ``seconds``; the
        rate's time runs to that step's end."""
        spans = []
        t_open = time.perf_counter()
        now = 0.0
        while now < seconds:
            if tracer is not None:
                tracer.before(now)
            t0 = time.perf_counter() - t_open
            with label("batch"):
                batch = {"tokens": torch.from_numpy(next(self.stream))}
            with label("step"):
                m = self.step(batch)
                loss = float(m["loss"])
            if loss != loss:
                raise FloatingPointError("the train step's loss is NaN")
            now = time.perf_counter() - t_open
            spans.append((t0, now))
            if tracer is not None:
                tracer.after(now, clock=lambda: time.perf_counter() - t_open)
        if tracer is not None:
            tracer.after(now, force=True)
        return Steps(now, len(spans), self.b * self.s, spans)

    def free(self) -> None:
        """Drop the step (its state and graph), keeping the initial
        params and the checked batches."""
        del self.step
