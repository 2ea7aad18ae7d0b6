"""Hard-anchor sampling and the dense InfoNCE.

Counterpart of ``contrastiveseg_tpu/ops/contrast.py``: the same
static-shape reformulation of the reference's per-image per-class sampling
loops (lib/loss/loss_contrast.py:30-89), with the same documented
divergences (no self-exclusion against the queue, class 0 included, rows
with no positive masked out).

Only the ``exact_sampling`` semantics are ported: sampling without
replacement ranks member pixels by uniform scores with an exact top-k.
The scores are an optional argument; by default they are drawn from a
``torch.Generator``.  Tests pass the JAX package's own draws, so both
packages pick the same pixels.

Under a process group the anchors are those of the global batch, as in the
JAX package's global-view step, where ``total_classes`` and the ``[:M]`` cut
span every device (``global_anchor_sample``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from contrastiveseg_tpu_torch.ops.resize import scale_target_nearest
from contrastiveseg_tpu_torch.parallel import all_gather_cat, distributed, rank_and_world

_NEG_INF = -1e30


class ContrastSpec(NamedTuple):
    num_classes: int
    max_samples: int = 1024
    max_views: int = 100
    temperature: float = 0.1
    base_temperature: float = 0.07


class AnchorSet(NamedTuple):
    feats: torch.Tensor  # [M, D]  M = min(max_samples, max_views * B * C)
    labels: torch.Tensor  # [M] int32
    valid: torch.Tensor  # [M] bool


def _revalidate(idx: torch.Tensor, mask: torch.Tensor):
    """Compact the picks that are pool members first (stable), and count them."""
    sel_ok = torch.gather(mask, -1, idx)
    order = torch.argsort((~sel_ok).to(torch.int8), dim=-1, stable=True)
    return torch.gather(idx, -1, order), sel_ok.sum(-1)


def hard_anchor_sample(
    embed: torch.Tensor,  # [B, N, D] L2-normalized pixel embeddings
    labels: torch.Tensor,  # [B, N] int ground truth
    predict: torch.Tensor,  # [B, N] int argmax predictions
    spec: ContrastSpec,
    scores: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> AnchorSet:
    """Vectorized ``_hard_anchor_sampling`` (loss_contrast.py:30-89).

    ``scores`` = (hard, easy) uniform draws of shape [B, C, N]; when None
    they come from ``torch.rand`` on ``generator``.
    """
    B, N, D = embed.shape
    sel_idx, sel_valid, sel_label = _select(labels, predict, spec, scores, generator)
    feats = embed.reshape(B * N, D)[sel_idx]
    feats = torch.where(sel_valid[:, None], feats, 0.0)
    return AnchorSet(feats=feats, labels=sel_label, valid=sel_valid)


def global_anchor_sample(
    embed: torch.Tensor,  # [B, N, D] this rank's rows of the global batch
    labels: torch.Tensor,  # [B, N]
    predict: torch.Tensor,  # [B, N]
    spec: ContrastSpec,
    scores: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> AnchorSet:
    """``hard_anchor_sample`` of the global batch, the ranks' rows in rank
    order; ``hard_anchor_sample`` itself without a process group.

    Every rank gathers the labels and predictions, and makes the same
    selection from the same global scores ([B_global, C, N]: given, or drawn
    from ``generator``, seeded alike on every rank).  Each rank fills the
    anchor rows it holds and zeros the others; a gather with gradients
    summed over the ranks gives every rank the global [M, D] anchors, bit
    for bit those of one process.  The loss of them is then the same on
    every rank, and the gather's backward sums the ranks' equal gradients:
    DDP's mean over the ranks leaves the global gradient."""
    if not distributed():
        return hard_anchor_sample(embed, labels, predict, spec, scores, generator)
    rank, world = rank_and_world()
    B, N, D = embed.shape
    sel_idx, sel_valid, sel_label = _select(all_gather_cat(labels), all_gather_cat(predict),
                                            spec, scores, generator)
    local = sel_idx - rank * B * N
    mine = sel_valid & (local >= 0) & (local < B * N)
    feats = embed.reshape(B * N, D)[local.clamp(0, B * N - 1)]
    feats = torch.where(mine[:, None], feats, 0.0)
    feats = all_gather_cat(feats, grad=True).view(world, -1, D).sum(0)
    return AnchorSet(feats=feats, labels=sel_label, valid=sel_valid)


def _select(labels: torch.Tensor, predict: torch.Tensor, spec: ContrastSpec,
            scores: Optional[tuple[torch.Tensor, torch.Tensor]],
            generator: Optional[torch.Generator]):
    """The anchors' flat pixel indices into [B * N], validity and labels,
    each [M]."""
    B, N = labels.shape
    C, V, M = spec.num_classes, spec.max_views, spec.max_samples
    dev = labels.device

    cls = torch.arange(C, device=dev, dtype=labels.dtype)
    member = labels[:, None, :] == cls[None, :, None]  # [B, C, N]
    count = member.sum(-1)  # [B, C]
    slot_valid = count > V  # reference: strictly greater (loss_contrast.py:40)

    total_classes = slot_valid.sum().clamp(min=1)
    n_view = torch.clamp(M // total_classes, 1, V)

    pred_is_c = predict[:, None, :] == cls[None, :, None]
    hard_mask = member & ~pred_is_c
    easy_mask = member & pred_is_c

    if scores is None:
        u_hard = torch.rand((B, C, N), generator=generator, device=dev)
        u_easy = torch.rand((B, C, N), generator=generator, device=dev)
    else:
        u_hard, u_easy = scores
    sh = torch.where(hard_mask, u_hard, _NEG_INF)
    se = torch.where(easy_mask, u_easy, _NEG_INF)
    hard_idx = torch.topk(sh, V, dim=-1).indices  # [B, C, V]
    easy_idx = torch.topk(se, V, dim=-1).indices

    hard_idx, num_hard = _revalidate(hard_idx, hard_mask)
    easy_idx, num_easy = _revalidate(easy_idx, easy_mask)

    # Keep-count rules (loss_contrast.py:66-77).
    half = n_view // 2
    both = (2 * num_hard >= n_view) & (2 * num_easy >= n_view)
    hard_rich = 2 * num_hard >= n_view
    num_hard_keep = torch.where(
        both, half, torch.where(hard_rich, n_view - num_easy, num_hard))
    num_hard_keep = torch.minimum(num_hard_keep.clamp(min=0),
                                  torch.minimum(n_view, num_hard))

    v_ids = torch.arange(V, device=dev)
    use_hard = v_ids[None, None, :] < num_hard_keep[..., None]  # [B, C, V]
    easy_pos = (v_ids[None, None, :] - num_hard_keep[..., None]).clamp(0, V - 1)
    easy_take = torch.gather(easy_idx, -1, easy_pos)
    pix_idx = torch.where(use_hard, hard_idx, easy_take)  # [B, C, V]

    supply = num_hard_keep + num_easy
    view_valid = (
        (v_ids[None, None, :] < n_view)
        & (v_ids[None, None, :] < supply[..., None])
        & slot_valid[..., None]
    )

    # View-major flat order, like the reference's unbind/cat.
    b_ids = torch.arange(B, device=dev)[:, None, None]
    flat_idx = (b_ids * N + pix_idx).permute(2, 0, 1).reshape(-1)  # [V*B*C]
    flat_valid = view_valid.permute(2, 0, 1).reshape(-1)
    flat_label = cls[None, :, None].expand(B, C, V).permute(2, 0, 1).reshape(-1)

    order = torch.argsort((~flat_valid).to(torch.int8), stable=True)[:M]
    return flat_idx[order], flat_valid[order], flat_label[order].to(torch.int32)


def contrastive_loss(
    anchors: AnchorSet,
    spec: ContrastSpec,
    queue_feats: Optional[torch.Tensor] = None,  # [K, D]
    queue_labels: Optional[torch.Tensor] = None,  # [K]
    queue_valid: Optional[torch.Tensor] = None,  # [K] bool
) -> torch.Tensor:
    """Dense masked InfoNCE (``_contrastive``, loss_contrast.py:91-128).

    With a queue, the anchors are scored against it; this materializes the
    [M, K] logits, so it is the oracle for small K only (the bank goes
    through K1).  Without one, the anchors are scored against each other
    and the diagonal is masked out of the positives and the negatives
    (the ``contrast_ce_loss`` path, [M, M] with M <= max_samples).
    """
    a_f, a_l, a_v = anchors
    if queue_feats is None:
        c_f, c_l, c_v = a_f, a_l, a_v
    else:
        c_f, c_l = queue_feats, queue_labels.to(torch.int32)
        c_v = (queue_valid if queue_valid is not None
               else torch.ones(c_f.shape[0], dtype=torch.bool, device=c_f.device))
    logits = (a_f.float() @ c_f.float().T) / spec.temperature

    same = a_l[:, None] == c_l[None, :]
    col_ok = c_v[None, :]
    pos_mask = same & col_ok
    neg_mask = ~same & col_ok
    if queue_feats is None:
        off_diag = ~torch.eye(logits.shape[0], dtype=torch.bool, device=logits.device)
        pos_mask = pos_mask & off_diag
        neg_mask = neg_mask & off_diag

    masked = torch.where(col_ok, logits, _NEG_INF)
    row_max = masked.max(dim=1, keepdim=True).values.detach()
    shifted = logits - row_max
    exp_shifted = torch.where(col_ok, torch.exp(shifted), 0.0)
    neg_sum = torch.where(neg_mask, exp_shifted, 0.0).sum(1, keepdim=True)
    log_prob = shifted - torch.log(exp_shifted + neg_sum + 1e-30)

    pos_cnt = pos_mask.sum(1)
    mean_log_prob_pos = torch.where(pos_mask, log_prob, 0.0).sum(1) / pos_cnt.clamp(min=1)
    row_ok = a_v & (pos_cnt > 0)
    per_row = -(spec.temperature / spec.base_temperature) * mean_log_prob_pos
    return torch.where(row_ok, per_row, 0.0).sum() / row_ok.sum().clamp(min=1)


def pixel_contrast_loss(
    embed: torch.Tensor,  # [B, H, W, D] NHWC normalized embeddings
    labels: torch.Tensor,  # [B, Hl, Wl] full-res ground truth
    predict: torch.Tensor,  # [B, H, W] argmax of stride-level logits
    spec: ContrastSpec,
    scores: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Label downscale -> sample (the global batch's anchors under a process
    group) -> InfoNCE of the anchors against each other
    (``PixelContrastLoss.forward``, loss_contrast.py:130-147)."""
    B, H, W, D = embed.shape
    labels_s = scale_target_nearest(labels, (H, W)).reshape(B, H * W)
    anchors = global_anchor_sample(embed.reshape(B, H * W, D), labels_s,
                                   predict.reshape(B, H * W), spec,
                                   scores=scores, generator=generator)
    return contrastive_loss(anchors, spec)
