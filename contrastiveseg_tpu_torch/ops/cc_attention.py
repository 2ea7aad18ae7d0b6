"""Criss-cross attention (CCNet), NCHW.

Counterpart of ``contrastiveseg_tpu/ops/cc_attention.py`` (:20-47), which
replaces the reference's CUDA extension (lib/extensions/cc_attention) by
einsums that XLA compiles outside any Pallas kernel.  Here they are
``torch.einsum`` products: each pixel attends over its column and its row,
the two sets of logits concatenated into one softmax over H + W.  The self
position appears in both; it is masked (-1e30) in the column pass, so that
it counts once, in the row pass.  Logits and softmax are fp32.
"""

from __future__ import annotations

import torch


def criss_cross_attention(query: torch.Tensor, key: torch.Tensor,
                          value: torch.Tensor) -> torch.Tensor:
    """``query``, ``key`` [B, Dk, H, W], ``value`` [B, Dv, H, W] -> the
    criss-cross context [B, Dv, H, W]."""
    H = query.shape[2]
    q, k = query.float(), key.float()
    col = torch.einsum("bdhw,bdkw->bhwk", q, k)  # pixel (h, w) against (k, w)
    eye = torch.eye(H, dtype=torch.bool, device=query.device)[None, :, None, :]
    col = col.masked_fill(eye, -1e30)
    row = torch.einsum("bdhw,bdhk->bhwk", q, k)  # pixel (h, w) against (h, k)
    attn = torch.softmax(torch.cat([col, row], dim=-1), dim=-1)
    a_col, a_row = attn[..., :H].to(value.dtype), attn[..., H:].to(value.dtype)
    out = (torch.einsum("bhwk,bdkw->bdhw", a_col, value)
           + torch.einsum("bhwk,bdhk->bdhw", a_row, value))
    return out
