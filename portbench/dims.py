"""A decoder configuration's sizes, read from its file's published keys
(the names of the model's own ``config.json``).

A file keeps every key at its published value.  Where the program runs
a key otherwise (a setting the release does not have, or one the
program does not model), ``departures`` names it with the value run:
``{"<key>": {"runs": <value>, "why": "..."}}``; the sizes are read
with those values in place."""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Dims:
    d: int
    layers: int
    hq: int
    hkv: int
    hd: int
    ff: int              # the MLP's width; a routed expert's under MoE
    ff_dense: int        # the leading dense layers' width
    vocab: int
    experts: int = 0
    shared: int = 0
    top_k: int = 0
    first_dense: int = 0
    renormalize: bool = True
    capacity_factor: float = 1.25
    eps: float = 1e-6
    rope_theta: float = 10_000.0
    tied: bool = False
    init_range: float = 0.02
    aux_alpha: float = 0.01

    @property
    def moe(self) -> bool:
        return self.experts > 0


# Granite's scalings, which neither the program nor the reference
# models: a configuration runs only where each is neutral.
NEUTRAL = ("embedding_multiplier", "residual_multiplier", "logits_scaling")


def as_run(conf: dict) -> dict:
    """The file's keys with its departures' values in place."""
    return {**conf, **{k: v["runs"]
                       for k, v in conf.get("departures", {}).items()}}


def dims(conf: dict) -> Dims:
    """Sizes of a configuration file (HF ``config.json`` keys), as run."""
    conf = as_run(conf)
    d = conf["hidden_size"]
    hq = conf["num_attention_heads"]
    moe = conf.get("n_routed_experts", 0) > 0
    hd = conf.get("head_dim", d // hq)
    off = [k for k in NEUTRAL if conf.get(k, 1.0) != 1.0]
    if not math.isclose(conf.get("attention_multiplier", hd ** -0.5),
                        hd ** -0.5):
        off.append("attention_multiplier")
    if off:
        raise ValueError(f"{', '.join(off)}: not modelled by the program; "
                         "run only at the neutral value")
    return Dims(
        d=d, layers=conf["num_hidden_layers"], hq=hq,
        hkv=conf.get("num_key_value_heads", hq),
        hd=hd,
        ff=conf["moe_intermediate_size"] if moe else conf["intermediate_size"],
        ff_dense=conf["intermediate_size"], vocab=conf["vocab_size"],
        experts=conf.get("n_routed_experts", 0),
        shared=conf.get("n_shared_experts", 0),
        top_k=conf.get("num_experts_per_tok", 0),
        first_dense=conf.get("first_k_dense_replace", 0) if moe else 0,
        renormalize=conf.get("norm_topk_prob", True),
        capacity_factor=conf.get("capacity_factor", 1.25),
        eps=conf["rms_norm_eps"], rope_theta=float(conf["rope_theta"]),
        tied=conf.get("tie_word_embeddings", False),
        init_range=conf.get("initializer_range", 0.02),
        aux_alpha=conf.get("aux_loss_alpha", 0.01))


def capacity(n_tokens: int, dm: Dims) -> int:
    """Rows each expert's buffer holds for ``n_tokens`` routed together:
    ceil(n k / E x capacity factor), rounded up to 8, at least 8."""
    c = int(math.ceil(n_tokens * dm.top_k / dm.experts
                      * dm.capacity_factor))
    return max(8, -(-c // 8) * 8)
