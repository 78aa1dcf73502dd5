"""Plain PyTorch version of the paged-attention decode kernel (the
contract of ``repro.kernels.paged_attention.ref.paged_attention_ref``).

Gathers the pages back into a dense (b, hkv, nb * block_tokens, d) view
through the block tables and runs masked single-query attention: the
kernel's online softmax without the paging.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        window: int = 0):
    """q: (b, hq, d); k_pages, v_pages: (hkv, n_pages, block_tokens, d);
    block_tables: (b, nb) int; lengths: (b,) int (0 = inactive row,
    output zeros).  Returns (b, hq, d) in q.dtype."""
    b, hq, d = q.shape
    hkv, _, block_tokens, _ = k_pages.shape
    g = hq // hkv
    nb = block_tables.shape[1]
    skv = nb * block_tokens
    bt = block_tables.long()

    # (hkv, b, nb, bt, d) -> (b, hkv, skv, d): pages in table order are
    # positions in ascending order
    k = k_pages[:, bt].transpose(0, 1).reshape(b, hkv, skv, d).float()
    v = v_pages[:, bt].transpose(0, 1).reshape(b, hkv, skv, d).float()

    qg = q.reshape(b, hkv, g, d).float() * d ** -0.5
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k)

    pos = torch.arange(skv, device=q.device)[None, None, None, :]
    ln = lengths.long()[:, None, None, None]
    mask = pos < ln
    if window > 0:
        mask &= pos > (ln - 1 - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))

    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    p = e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v)
    return o.reshape(b, hq, d).to(q.dtype)
