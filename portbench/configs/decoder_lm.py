"""Plain PyTorch reference of a decoder-only language model, dense or
mixture of experts: the configurations ``deepseek-moe-16b`` (and its
training cut) and ``granite-3-8b``.

It follows the published description, in fp32 (TF32 off), with no
kernel, cache or batching of the program's, and imports nothing of the
program: pre-norm blocks (RMSNorm), rotary embeddings (the half-split
rotation, ``rope_theta``), grouped-query attention (query head j reads
key head j // (hq / hkv)), causal softmax at 1 / sqrt(head_dim), SwiGLU
MLPs (silu(x wg) * (x wi)) wo); under MoE a softmax router over the
experts, the top k kept (their gates renormalised where
``norm_topk_prob`` says so), the routed experts' SwiGLU outputs weighted
by their gates, plus the shared experts as one SwiGLU of
``n_shared_experts`` x the expert width.

Departures that the configuration states and the reference keeps:
``capacity_factor``: tokens routed together (a training batch, a
served prompt) give each expert at most ``dims.capacity`` rows, taken
in the order of (token, rank of the pick); the assignments past it are
dropped.  A served token's own step routes without a capacity.  The
training loss adds ``aux_loss_alpha`` x the Switch load-balancing loss
(E x sum_e f_e P_e, f_e the share of tokens whose first pick is e, P_e
the mean router probability) of every MoE layer.

``quant=True`` computes the control: every matrix product's operands
rounded to fp8 (e4m3, one scale per tensor, per expert for the
experts), the rest as above; in training the rounding is a straight-
through one, so the backward's products read the rounded operands.

Weights are the tree of ``portbench/weights.py``'s layout, in any
dtype; each layer's are cast to fp32 when it runs.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from portbench.dims import Dims, capacity

FP8_MAX = 448.0


def exact_fp32() -> None:
    """No TF32 in fp32 products, on either backend."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _q8(x: torch.Tensor) -> torch.Tensor:
    s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _op(x: torch.Tensor, quant: bool) -> torch.Tensor:
    """An operand of a product: fp32, or rounded to fp8 (straight
    through for the gradient)."""
    x = x.float()
    if not quant:
        return x
    return x + (_q8(x) - x).detach()


def mm(a, b, quant: bool = False):
    return _op(a, quant) @ _op(b, quant)


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x, pos, theta: float):
    """x (B, S, h, hd), pos (S,)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(h, aw, dm: Dims, quant: bool):
    """Causal self-attention of h (B, S, d)."""
    B, S, _ = h.shape
    pos = torch.arange(S, device=h.device)
    q = rope(mm(h, aw["wq"], quant).view(B, S, dm.hq, dm.hd), pos,
             dm.rope_theta)
    k = rope(mm(h, aw["wk"], quant).view(B, S, dm.hkv, dm.hd), pos,
             dm.rope_theta)
    v = mm(h, aw["wv"], quant).view(B, S, dm.hkv, dm.hd)
    g = dm.hq // dm.hkv
    q = q.view(B, S, dm.hkv, g, dm.hd)
    # query blocks small enough that a block's scores stay under ~512 MB
    qb = max(1, min(S, 2**27 // max(1, B * dm.hq * S)))
    outs = []
    for s0 in range(0, S, qb):
        s1 = min(S, s0 + qb)
        sc = torch.einsum("bqhgd,bkhd->bhgqk", _op(q[:, s0:s1], quant),
                          _op(k[:, :s1], quant)) / math.sqrt(dm.hd)
        keep = (torch.arange(s1, device=h.device)[None, :]
                <= torch.arange(s0, s1, device=h.device)[:, None])
        sc = sc.masked_fill(~keep, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        outs.append(torch.einsum("bhgqk,bkhd->bqhgd", _op(p, quant),
                                 _op(v[:, :s1], quant)))
    o = torch.cat(outs, dim=1).reshape(B, S, dm.hq * dm.hd)
    return mm(o, aw["wo"], quant)


def swiglu(x, wi, wg, wo, quant: bool):
    return mm(torch.nn.functional.silu(mm(x, wg, quant)) * mm(x, wi, quant),
              wo, quant)


def route(x2d, router, dm: Dims, quant: bool, cap_rows: int):
    """Gates (T, k), expert ids (T, k), the kept mask (T, k) and the
    layer's load-balancing loss.  The first ``cap_rows`` rows were
    routed together and are held to the capacity; the others (a served
    token's own steps) are not."""
    probs = torch.softmax(mm(x2d, router, quant), dim=-1)
    gates, idx = torch.topk(probs, dm.top_k, dim=-1)
    if dm.renormalize:
        gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    keep = torch.ones_like(idx, dtype=torch.bool)
    if cap_rows:
        flat = idx[:cap_rows].reshape(-1)
        order = torch.argsort(flat, stable=True)
        e_sorted = flat[order]
        starts = torch.searchsorted(
            e_sorted, torch.arange(dm.experts, device=flat.device,
                                   dtype=e_sorted.dtype))
        slot = torch.empty_like(flat)
        slot[order] = (torch.arange(flat.numel(), device=flat.device)
                       - starts[e_sorted])
        keep[:cap_rows] = (slot < capacity(cap_rows, dm)).view(cap_rows,
                                                               dm.top_k)
    f = torch.nn.functional.one_hot(idx[:, 0], dm.experts).float().mean(0)
    aux = dm.experts * torch.sum(f * probs.mean(0))
    return gates, idx, keep, aux


def moe(h, mw, dm: Dims, quant: bool, cap_rows: int):
    """h (B, S, d) -> (out, aux)."""
    B, S, d = h.shape
    x2d = h.reshape(B * S, d)
    gates, idx, keep, aux = route(x2d, mw["router"], dm, quant, cap_rows)
    out = torch.zeros_like(x2d)
    ex = mw["experts"]
    for e in range(dm.experts):
        tok, j = torch.nonzero((idx == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(x2d[tok], ex["wi"][e], ex["wg"][e], ex["wo"][e], quant)
        out = out.index_add(0, tok, y * gates[tok, j][:, None])
    if dm.shared:
        sw = mw["shared"]
        out = out + swiglu(x2d, sw["wi"], sw["wg"], sw["wo"], quant)
    return out.view(B, S, d), aux


def _layer(weights, i: int, dm: Dims):
    if i < dm.first_dense:
        return weights["dense_layers"][str(i)], False
    j = i - dm.first_dense

    def take(node):
        return ({k: take(v) for k, v in node.items()}
                if isinstance(node, dict) else node[j])

    return take(weights["blocks"]), dm.moe


def final_hidden(weights, tokens, dm: Dims, quant: bool = False,
                 cap_rows: Optional[int] = None):
    """The final norm's output (B, S, d) over ``tokens`` (B, S) and the
    summed load-balancing loss.  ``cap_rows``: the leading (flattened)
    rows held to the experts' capacity (None: all of them)."""
    B, S = tokens.shape
    cap = B * S if cap_rows is None else cap_rows
    x = weights["embed"]["tok"][tokens.long()].float()
    aux = torch.zeros((), device=x.device)
    for i in range(dm.layers):
        lw, is_moe = _layer(weights, i, dm)
        x = x + attention(rmsnorm(x, lw["ln1"], dm.eps), lw["attn"], dm,
                          quant)
        h = rmsnorm(x, lw["ln2"], dm.eps)
        if is_moe:
            out, a = moe(h, lw["moe"], dm, quant, cap)
            aux = aux + a
        else:
            m = lw["mlp"]
            out = swiglu(h, m["wi"], m["wg"], m["wo"], quant)
        x = x + out
    return rmsnorm(x, weights["final_norm"], dm.eps), aux


def head(weights, dm: Dims):
    return weights["embed"]["tok"].T if dm.tied else weights["lm_head"]


@torch.no_grad()
def served_logits(weights, prompt, served: List[int], dm: Dims,
                  quant: bool = False):
    """fp32 logits (n, V) at the positions that chose each served token:
    the prompt's last, then each served token's but the last's, over
    one forward of prompt + served[:-1]; the prompt routed together
    under the capacity, the served tokens each on its own."""
    dev = weights["embed"]["tok"].device
    seq = torch.as_tensor(list(prompt) + list(served[:-1]), device=dev)
    h, _ = final_hidden(weights, seq[None], dm, quant, cap_rows=len(prompt))
    rows = h[0, len(prompt) - 1:]
    return mm(rows, head(weights, dm), quant)


def loss(weights, tokens, dm: Dims, quant: bool = False):
    """Mean next-token cross-entropy over tokens (B, S) plus
    ``aux_loss_alpha`` x the summed load-balancing loss (MoE)."""
    h, aux = final_hidden(weights, tokens, dm, quant)
    logits = mm(h[:, :-1], head(weights, dm), quant)
    xent = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1).long())
    return xent + dm.aux_alpha * aux if dm.moe else xent


def adamw_steps(params: Dict[str, torch.Tensor], batches, dm: Dims,
                opt: dict, quant: bool = False):
    """AdamW (decoupled weight decay, global-norm clipping, bias-corrected
    moments) over ``batches`` from fp32 ``params`` (flat {name: tensor},
    the tree's layout by dotted name), in place.  Returns the losses,
    the first step's clipped gradient per leaf and each leaf's first
    raw gradient."""
    from portbench.weights import nest

    names = sorted(params)
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    losses, first_seen = [], None
    b1, b2 = opt["b1"], opt["b2"]
    for t, batch in enumerate(batches, start=1):
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        value = loss(nest(leaves), batch, dm, quant)
        grads = torch.autograd.grad(value, [leaves[n] for n in names])
        losses.append(float(value.detach()))
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(opt["grad_clip"] / (gnorm + 1e-9), max=1.0)
        with torch.no_grad():
            if first_seen is None:
                first_seen = {n: g * scale for n, g in zip(names, grads)}
            for n, g in zip(names, grads):
                g = g * scale
                m[n].mul_(b1).add_((1 - b1) * g)
                v[n].mul_(b2).add_((1 - b2) * g * g)
                delta = (m[n] / (1 - b1 ** t)) / (
                    torch.sqrt(v[n] / (1 - b2 ** t)) + opt["eps"])
                p = params[n]
                p.sub_(opt["lr"] * (delta + opt["weight_decay"] * p))
        del leaves, grads, value
    return losses, first_seen
