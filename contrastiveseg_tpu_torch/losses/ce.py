"""Cross-entropy with torch semantics: plain, OHEM, aux and upsampled.

Counterpart of ``contrastiveseg_tpu/losses/ce.py`` (FSCELoss, FSOhemCELoss
and FSAuxCELoss, loss_helper.py:169-313): per-class weights with the mean
taken over the sum of the contributing weights, ``ignore_index`` pixels
dropped from numerator and denominator.  Logits are NHWC [B, H, W, C],
labels [B, H, W].
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from contrastiveseg_tpu_torch.ops.resize import align_corners_matrix, scale_target_nearest


def _weights(safe: torch.Tensor, valid: torch.Tensor,
             class_weight: Optional[torch.Tensor]) -> torch.Tensor:
    w = (class_weight[safe] if class_weight is not None
         else torch.ones(safe.shape, dtype=torch.float32, device=safe.device))
    return torch.where(valid, w, 0.0)


def _class_weight(class_weight, device) -> Optional[torch.Tensor]:
    if class_weight is None:
        return None
    return torch.as_tensor(class_weight, dtype=torch.float32, device=device)


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weight: Optional[Sequence[float]] = None,
    ignore_index: int = -1,
) -> torch.Tensor:
    """FSCELoss: weighted CE, ignore-index, torch 'mean' normalization."""
    if logits.shape[1:3] != labels.shape[1:3]:
        labels = scale_target_nearest(labels, (logits.shape[1], logits.shape[2]))
    C = logits.shape[-1]
    valid = labels != ignore_index
    safe = labels.clamp(0, C - 1).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    w = _weights(safe, valid, _class_weight(class_weight, logits.device))
    return (nll * w).sum() / w.sum().clamp(min=1e-12)


def ohem_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    thresh: float = 0.9,
    min_kept: int = 100000,
    class_weight: Optional[Sequence[float]] = None,
    ignore_index: int = -1,
) -> torch.Tensor:
    """FSOhemCELoss (loss_helper.py:215-261): online hard-example mining.

    Keeps the pixels whose probability of the true class is below
    ``max(thresh, sorted_p[k])``, ``k = min(min_kept, n_valid - 1)``, and
    takes the *unweighted* mean of their class-weighted CE.  Ignored pixels
    get probability 2.0, so they sort last.  The k-th order statistic comes
    from a full sort indexed by a device tensor (no host sync); its value,
    and so the kept set, does not depend on how ties are ordered.
    """
    if logits.shape[1:3] != labels.shape[1:3]:
        labels = scale_target_nearest(labels, (logits.shape[1], logits.shape[2]))
    C = logits.shape[-1]
    valid = labels != ignore_index
    safe = labels.clamp(0, C - 1).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    with torch.no_grad():  # the threshold selects pixels; no gradient flows through it
        p_true = torch.gather(F.softmax(logits.float(), dim=-1), -1, safe[..., None])[..., 0]
        p_masked = torch.where(valid, p_true, 2.0)
        sorted_p = torch.sort(p_masked.reshape(-1)).values
        k = torch.clamp(valid.sum() - 1, min=0, max=min_kept)
        threshold = sorted_p[k].clamp(min=thresh)
        keep = valid & (p_masked < threshold)
    w = _weights(safe, valid, _class_weight(class_weight, logits.device))
    return torch.where(keep, nll * w, 0.0).sum() / keep.sum().clamp(min=1)


def aux_cross_entropy(
    seg_logits: torch.Tensor,
    aux_logits: torch.Tensor,
    labels: torch.Tensor,
    seg_weight: float = 1.0,
    aux_weight: float = 0.4,
    class_weight: Optional[Sequence[float]] = None,
    ignore_index: int = -1,
) -> torch.Tensor:
    """FSAuxCELoss (loss_helper.py:301-313)."""
    return (seg_weight * cross_entropy(seg_logits, labels, class_weight, ignore_index)
            + aux_weight * cross_entropy(aux_logits, labels, class_weight, ignore_index))


def _block_loss(seg_t, a_h_blk, a_w, lab_blk, cw, ignore_index):
    up = torch.einsum("rp,bcpq->bcrq", a_h_blk, seg_t)
    up = torch.einsum("oq,bcrq->bcro", a_w, up)  # [B, C, r, W]
    C = up.shape[1]
    valid = lab_blk != ignore_index
    safe = lab_blk.clamp(0, C - 1).long()
    true_logit = torch.gather(up, 1, safe[:, None])[:, 0]
    nll = torch.logsumexp(up, dim=1) - true_logit
    w = _weights(safe, valid, cw)
    return torch.stack([(nll * w).sum(), w.sum()])


def upsampled_cross_entropy(
    seg: torch.Tensor,  # [B, h, w, C] stride-level logits
    labels: torch.Tensor,  # [B, H, W] full-res labels
    class_weight: Optional[Sequence[float]] = None,
    ignore_index: int = -1,
    row_block: int = 64,
) -> torch.Tensor:
    """CE on align-corners-upsampled logits without materializing them.

    Equals ``cross_entropy(resize_bilinear_align_corners(seg, (H, W)),
    labels)`` (the reference's ContrastCELoss path, loss_contrast.py:181),
    in exact fp32 (the JAX package's ``precision="highest"``).  The loss is
    summed over blocks of ``row_block`` output rows, each under
    ``torch.utils.checkpoint``, so only one [B, C, row_block, W] block of
    upsampled logits exists at a time, in the forward and in the backward.
    The NLL is ``logsumexp(up) - up[true]``.
    """
    B, h, w, C = seg.shape
    H, W = labels.shape[1], labels.shape[2]
    if (h, w) == (H, W):
        return cross_entropy(seg, labels, class_weight, ignore_index)
    dev = seg.device
    a_h = align_corners_matrix(H, h, dev)
    a_w = align_corners_matrix(W, w, dev)
    seg_t = seg.float().permute(0, 3, 1, 2)  # [B, C, h, w]
    cw = _class_weight(class_weight, dev)
    total = torch.zeros(2, dtype=torch.float32, device=dev)
    for r0 in range(0, H, row_block):
        total = total + checkpoint(
            _block_loss, seg_t, a_h[r0:r0 + row_block], a_w,
            labels[:, r0:r0 + row_block], cw, ignore_index,
            use_reentrant=False)
    return total[0] / total[1].clamp(min=1e-12)
