"""Primitive layers (the port's ``repro.models.layers``).

Same numerics contract as the reference: norms compute in fp32 and cast
back; ``dense`` multiplies in the compute dtype with fp32 accumulation
(cuBLAS accumulates bf16 products in fp32) and casts back; logits come
out in fp32 from compute-dtype operands.

Under a ``ParallelCtx`` with DTensor operands (the sharded train step)
the embedding lookup, RoPE, the logits head and the cross-entropy run on
each rank's blocks (``repro_torch.parallel.ctx.run_local``): the lookup
and the loss vocab-parallel over the model axis, as the reference's
vocab-sharded logits imply; with plain tensors they are unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.config import ModelConfig
from repro_torch.parallel.ctx import (get_ctx, param_grad_placements,
                                      run_local)


def rmsnorm(x, w, eps: float):
    dt = x.dtype
    x32 = x.float()
    x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * w.float()).to(dt)


def layernorm(x, w, b, eps: float):
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def norm(x, block, name: str, cfg: ModelConfig):
    if cfg.norm_type == "layernorm":
        return layernorm(x, block[name], block[f"{name}_b"], cfg.norm_eps)
    return rmsnorm(x, block[name], cfg.norm_eps)


class DenseBf16Grad(torch.autograd.Function):
    """x @ w whose weight gradient comes out in w's dtype (the reference's
    ``_dense_bf16grad``): on a mesh the batch and sequence contraction
    of that gradient is split over the data axis, so its per-rank
    partial product, in bf16, is what the data-parallel reduction
    moves."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        gx = torch.matmul(dy, w.T)
        gw = torch.einsum("...d,...f->df", x, dy).to(w.dtype)
        return gx, gw


def seq_whole(x):
    """DTensor ``x`` (b, ..., d) with its middle dims gathered (the
    sequence of Megatron's sequence parallelism, before a column-parallel
    product or the RWKV token shift): the product flattens (b, ...) into
    rows, which a split past the first dim does not survive; a plain
    tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    plc = tuple(Replicate() if isinstance(p, Shard)
                and 0 < p.dim < x.dim() - 1 else p for p in x.placements)
    if plc == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, plc)


class SeqWholeGrad(torch.autograd.Function):
    """The identity whose backward is :func:`seq_whole`: a product's
    output cotangent, split on the sequence where the product's consumer
    (the residual add of a sequence-parallel block) put it, is gathered
    there before the product's backward flattens (b, s) into rows.
    DTensor cannot view two split dims as one on every torch version
    (2.11 refuses the flatten), so the gather is made explicit."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return seq_whole(g)


def dense(x, w, b=None):
    """x @ w in compute dtype with fp32 accumulation; under a context
    with ``bf16_grad``, a 2-D weight already in x's dtype goes through
    :class:`DenseBf16Grad`.  A DTensor ``x`` is multiplied with its
    sequence whole (:func:`seq_whole`), and the product's gradient
    arrives so (:class:`SeqWholeGrad`)."""
    ctx = get_ctx()
    if isinstance(x, DTensor) and x.dim() > 2:
        x = seq_whole(x)
    if ctx is not None and ctx.bf16_grad and w.dim() == 2 \
            and w.dtype == x.dtype:
        y = DenseBf16Grad.apply(x, w)
    else:
        y = torch.matmul(x, w.to(x.dtype))
    if isinstance(y, DTensor) and y.dim() > 2:
        y = SeqWholeGrad.apply(y)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _act(cfg: ModelConfig):
    if cfg.mlp_activation == "silu":
        return F.silu
    # jax.nn.gelu defaults to the tanh approximation
    return lambda h: F.gelu(h, approximate="tanh")


def mlp(x, p, cfg: ModelConfig):
    """(Gated) MLP: silu/gelu — SwiGLU or GeGLU when cfg.mlp_gated."""
    act = _act(cfg)
    h = dense(x, p["wi"])
    if cfg.mlp_gated:
        h = act(dense(x, p["wg"])) * h
    else:
        h = act(h)
    return dense(h, p["wo"])


def rope(x, positions, theta: float):
    """Rotary embedding. x: (..., seq, heads, head_dim); positions: (..., seq).
    A DTensor ``x`` (seq and head_dim whole on each rank) rotates its
    blocks in place of the whole; DTensor ``positions`` (a decode step's
    (b, 1) rows) are placed on x's batch split, whole elsewhere."""
    if isinstance(x, DTensor):
        plc = tuple(x.placements)
        pos_plc = None
        if isinstance(positions, DTensor):
            pos_plc = tuple(Shard(0) if p == Shard(0) else Replicate()
                            for p in plc)
        return run_local(lambda t, pos: rope(t, pos, theta), x.device_mesh,
                         (x, positions), (plc, pos_plc), plc)
    head_dim = x.shape[-1]
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., :, None].float() * freqs    # (..., seq, half)
    cos = torch.cos(angles)[..., :, None, :]             # (..., seq, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def embed_tokens(tokens, w, compute_dtype):
    if isinstance(w, DTensor):
        return _embed_sharded(tokens, w).to(compute_dtype)
    return w[tokens].to(compute_dtype)


def _vocab_offset(mesh, dims, vocab: int) -> int:
    """The first vocab id of this rank's block of a vocab of ``vocab``
    ids split over the mesh dims ``dims`` (outer first);
    ``ValueError`` where the split is uneven, whose blocks no one
    offset rule addresses."""
    n, block = 1, 0
    for i in sorted(dims):
        n *= mesh.size(i)
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    if vocab % n:
        raise ValueError(f"a vocab of {vocab} does not split evenly over "
                         f"{n} ranks")
    return block * (vocab // n)


def _embed_sharded(tokens, w):
    """Vocab-parallel lookup of tokens (b, s) in a DTensor table (V, d):
    the table's vocab blocks stay where they are (its embed dim is
    gathered), the tokens are gathered to the batch split only; each rank
    looks up the tokens of its vocab block (zero rows for the others),
    and the sum over the vocab ranks is the output's ``Partial``."""
    if not isinstance(tokens, DTensor):
        raise TypeError("a sharded table takes DTensor tokens")
    ctx = get_ctx()
    mesh = w.device_mesh
    vocab_dims = {i for i, p in enumerate(w.placements)
                  if isinstance(p, Shard) and p.dim == 0}
    w_plc = tuple(Shard(0) if i in vocab_dims else Replicate()
                  for i in range(mesh.ndim))
    t_plc = ctx.placements("kv_rep", 2)
    batch = {i for i, p in enumerate(t_plc) if isinstance(p, Shard)}
    out_plc = tuple(Partial() if i in vocab_dims else
                    Shard(0) if i in batch else Replicate()
                    for i in range(mesh.ndim))
    w_grad = param_grad_placements(t_plc, w_plc)
    offset = _vocab_offset(mesh, vocab_dims, w.shape[0])

    def body(tok, wl):
        idx = tok.long() - offset
        ok = (idx >= 0) & (idx < wl.shape[0])
        rows = wl[idx.clamp(0, wl.shape[0] - 1)]
        return torch.where(ok[..., None], rows, rows.new_zeros(()))

    return run_local(body, mesh, (tokens, w), (t_plc, w_plc), out_plc,
                     (None, w_grad))


class HeadFn(torch.autograd.Function):
    """logits = x @ w for compute-dtype (bf16) ``x`` (n, d) and ``w`` (d,
    V): products summed in fp32, fp32 logits (the reference's
    ``preferred_element_type=float32``).  On CUDA one bf16 GEMM with fp32
    output (``aten::mm.dtype``, a library GEMM: the reference computes
    this product outside any Pallas kernel); on the CPU, which has no
    kernel for it, an fp32 GEMM of the operands cast up, the same values
    up to summation order.

    The backward is the reference's transpose rule (``dot_general``'s
    ``_dot_general_transpose_lhs`` / ``_rhs``): the fp32 cotangent times
    the other operand cast up, summed in fp32, cast to the operand's
    dtype (:func:`head_backward`)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            return torch.mm(x, w, out_dtype=torch.float32)
        return torch.mm(x.float(), w.float())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return head_backward(g, x, w, *ctx.needs_input_grad[:2])


def head_backward(g, x, w, need_x: bool = True, need_w: bool = True):
    """(dx, dw) of :class:`HeadFn` for the fp32 cotangent ``g`` (n, V):
    two fp32 GEMMs, each result cast to its operand's dtype (``None``
    where not needed)."""
    dx = torch.mm(g, w.float().T).to(x.dtype) if need_x else None
    dw = torch.mm(x.float().T, g).to(w.dtype) if need_w else None
    return dx, dw


def lm_logits(x, params, cfg: ModelConfig, softcap: float = 0.0):
    """fp32 logits of compute-dtype inputs: the head is cast to ``x``'s
    dtype and multiplied with fp32 accumulation (the reference's
    ``preferred_element_type=float32``): fp32 ``x`` by one fp32 GEMM,
    anything narrower through :class:`HeadFn`.  A tree from
    ``compute_params`` carries the cast head as ``params["head"]``."""
    head = params.get("head")
    if head is None:
        w = (params["embed"]["tok"].T if cfg.tie_embeddings
             else params["lm_head"])
        head = w.to(x.dtype)
    if isinstance(x, DTensor):
        logits = _logits_sharded(x, head)
    else:
        logits = _head(x, head)
    cap = softcap or cfg.logit_softcap
    if cap > 0:
        logits = cap * torch.tanh(logits / cap)
    return logits


def _head(x, head):
    """fp32 logits of x (..., d) and head (d, V) on plain tensors."""
    if x.dtype == torch.float32:
        return torch.matmul(x, head)
    return HeadFn.apply(x.reshape(-1, x.shape[-1]), head).view(
        *x.shape[:-1], head.shape[-1])


def _logits_sharded(x, head):
    """Logits of a DTensor ``x`` (b, s, d): x gathered to its batch split,
    the head's vocab blocks kept (its embed dim gathered); each rank's
    product is its vocab block of the logits (the reference's logits
    spec), and x's gradient a ``Partial`` over the vocab ranks."""
    ctx = get_ctx()
    mesh = x.device_mesh
    nd = x.dim()
    vocab_dims = {i for i, p in enumerate(head.placements)
                  if isinstance(p, Shard) and p.dim == 1}
    x_plc = ctx.placements("kv_rep", nd)
    h_plc = tuple(Shard(1) if i in vocab_dims else Replicate()
                  for i in range(mesh.ndim))
    out_plc = tuple(Shard(nd - 1) if i in vocab_dims else x_plc[i]
                    for i in range(mesh.ndim))
    x_grad = tuple(Partial() if i in vocab_dims else x_plc[i]
                   for i in range(mesh.ndim))
    h_grad = param_grad_placements(x_plc, h_plc)
    return run_local(_head, mesh, (x, head), (x_plc, h_plc), out_plc,
                     (x_grad, h_grad))


def softmax_xent(logits, labels):
    """Mean token cross-entropy in fp32 (``repro.models.layers.
    softmax_xent``): logsumexp of each row less its gold logit."""
    if isinstance(logits, DTensor):
        return _xent_sharded(logits, labels)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def _xent_sharded(logits, labels):
    """Vocab-parallel cross-entropy of DTensor logits (b, s, V): each rank
    takes the log-sum-exp of its vocab block and the gold logits that
    fall in it; the blocks' log-sum-exps are gathered and combined, the
    gold logits summed (a ``Partial``), and each batch rank's mean,
    weighted by its share of the tokens, summed into the loss.  With one
    vocab block it is the plain loss, bit for bit; an uneven vocab split
    is refused (``ValueError``: the "logits" kind never makes one)."""
    ctx = get_ctx()
    mesh = logits.device_mesh
    nd = logits.dim()
    vocab_dims = {i for i, p in enumerate(logits.placements)
                  if isinstance(p, Shard) and p.dim == nd - 1}
    row_plc = ctx.placements("kv_rep", nd - 1)
    batch = {i for i, p in enumerate(row_plc) if isinstance(p, Shard)}
    l_plc = tuple(Shard(nd - 1) if i in vocab_dims else row_plc[i]
                  for i in range(mesh.ndim))
    gold_plc = tuple(Partial() if i in vocab_dims else row_plc[i]
                     for i in range(mesh.ndim))
    offset = _vocab_offset(mesh, vocab_dims, logits.shape[-1])

    def parts(lg, lab):
        lg = lg.float()
        lse = torch.logsumexp(lg, dim=-1, keepdim=True)
        idx = lab.long() - offset
        ok = (idx >= 0) & (idx < lg.shape[-1])
        gold = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])
        return lse, torch.where(ok, gold[..., 0], gold.new_zeros(()))

    lse, gold = run_local(parts, mesh, (logits, labels), (l_plc, row_plc),
                          (l_plc, gold_plc))
    total = labels.numel()
    out_plc = tuple(Partial() if i in batch else Replicate()
                    for i in range(mesh.ndim))

    def mean(lse_all, g):
        return (torch.mean(torch.logsumexp(lse_all, dim=-1) - g)
                * (g.numel() / total))

    loss = run_local(mean, mesh, (lse, gold), (row_plc, row_plc), out_plc)
    return loss.redistribute(mesh, (Replicate(),) * mesh.ndim)
