"""The one generator of every traffic mix: a mix file is data only.

Serving mixes (``"kind": "serve"``) give the arrivals, the prompt and
output length distributions and the engine's sizes.  Sizes and gaps are
stratified: each block of ``BLOCK`` requests holds one draw from each of
``BLOCK`` equal-probability strata of each distribution, the length at
the quantile (i + u) / BLOCK with u uniform in [0, 1) from the seed, so
lengths are continuous (a prompt length is rarely seen twice) while
every seed offers nearly the same work at the same rate, in another
order; a window that ends inside a block differs from another seed's
by less than a block.

* ``arrivals.process == "stratified"``: open loop at ``rate_per_s``; the
  gaps of a block are the exponential distribution's quantiles at
  (i + 0.5) / BLOCK, in a seeded order, so a block of requests always
  spans the same time.  Within a block the gaps are Poisson's; over a
  block or more the arrivals are steadier than a Poisson process's.
  Requests are generated while they are due before the window closes.
* ``arrivals.process == "backlog"``: ``requests`` requests all due at
  the window's start (an offline batch that the window cannot finish).

Lengths: ``{"dist": "lognormal", "median", "sigma", "min", "max"}``,
rounded to whole tokens and clipped.  Token ids are uniform over the
vocabulary.  ``max_new`` counts every output token, the prefill's one
included, as the engine's ``ServeRequest.max_new`` does.

Training mixes (``"kind": "train"``) draw their batches as the program's
``data.pipeline.DataPipeline`` draws them, copied here: int32 tokens
uniform over the vocabulary from ``numpy.random.default_rng(seed)``.
"""
from __future__ import annotations

import dataclasses
from statistics import NormalDist
from typing import Iterator, List, Optional

import numpy as np

BLOCK = 32                       # requests a stratified block holds

@dataclasses.dataclass
class Request:
    rid: int
    t_due: float                 # seconds after the window opens
    prompt: np.ndarray           # int64 token ids
    max_new: int                 # output tokens, the prefill's included


def quantiles(dist: dict, n: int, u=0.5) -> np.ndarray:
    """The distribution's quantiles at (i + u) / n, i < n (``u`` a
    number, or an array of n)."""
    q = (np.arange(n) + u) / n
    if dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(p)) for p in q])
        x = dist["median"] * np.exp(dist["sigma"] * z)
        return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


def exp_gaps(rate: float, n: int) -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate


def serve_requests(mix: dict, seed: int, seconds: float, vocab: int,
                   rate: Optional[float] = None) -> List[Request]:
    """The requests of one run.  ``rate`` overrides the mix's (the knee
    sweep's)."""
    rng = np.random.default_rng(seed)
    arr = mix["arrivals"]
    if arr["process"] == "backlog":
        n = int(arr["requests"])
        due = np.zeros(n)
    elif arr["process"] == "stratified":
        r = float(rate if rate is not None else arr["rate_per_s"])
        gaps = exp_gaps(r, BLOCK)
        due_l, t = [], 0.0
        while t < seconds:
            for g in rng.permutation(gaps):
                if t >= seconds:
                    break
                due_l.append(t)
                t += float(g)
        n = len(due_l)
        due = np.asarray(due_l)
    else:
        raise ValueError(f"unknown arrival process {arr['process']!r}")
    nb = -(-n // BLOCK)

    def lengths(dist):
        return np.concatenate([
            rng.permutation(quantiles(dist, BLOCK, rng.random(BLOCK)))
            for _ in range(nb)])[:n]

    plen, olen = lengths(mix["prompt_len"]), lengths(mix["output_len"])
    return [Request(i, float(due[i]),
                    rng.integers(0, vocab, int(plen[i]), dtype=np.int64),
                    int(olen[i]))
            for i in range(n)]


def train_batches(seed: int, batch: int, seq: int,
                  vocab: int) -> Iterator[np.ndarray]:
    """Endless (batch, seq) int32 batches of the seeded token stream
    (``DataPipeline``'s draw)."""
    rng = np.random.default_rng(seed)
    while True:
        yield rng.integers(0, vocab, (batch, seq), dtype=np.int32)


def check_sample(finished: list, seed: int, tokens: int) -> list:
    """The finished requests the reference checks: the longest one (by
    prompt and output), then others drawn from the seed until they
    hold ``tokens`` served tokens."""
    if not finished:
        return []
    rng = np.random.default_rng([seed, 7])
    longest = max(finished, key=lambda r: (len(r.prompt) + len(r.out_tokens), r.rid))
    rest = [r for r in finished if r is not longest]
    picked = [longest]
    served = len(longest.out_tokens)
    for i in rng.permutation(len(rest)):
        if served >= tokens:
            break
        picked.append(rest[int(i)])
        served += len(rest[int(i)].out_tokens)
    return picked
