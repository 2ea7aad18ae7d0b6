"""Region Mutual Information loss.

Counterpart of ``contrastiveseg_tpu/losses/rmi.py`` (the reference's
RMILoss, lib/loss/rmi_loss.py:200-402, its ``forward_sigmoid`` path): a
masked sigmoid BCE plus a lower bound of the region mutual information
between the one-hot labels and the sigmoid probabilities, from the
log-determinants of 3x3 (``radius``^2) neighbourhood covariances.

As in the JAX package, everything runs in fp32 (the reference promotes the
covariances to float64); the [radius^2, radius^2] matrices are regularised
by ``_POS_ALPHA``.  Both inputs are pooled first (``pool_way`` 0: max,
padding -inf; 1: mean over the window's pixels inside the image).  The
inverse and the Cholesky factor come from ``torch.linalg.inv_ex`` and
``cholesky_ex``, which do not check for failure on the host, so a step on
the GPU does not wait for the card.  Where a matrix is not positive
definite, JAX's Cholesky returns NaN, and so does the port: the
log-determinant of each matrix whose factorisation failed is NaN, and the
loss with it.

Inputs are NHWC, as the port's losses take them: logits [N, H, W, C] and
int labels [N, H, W], ignored where outside [0, C).

Under a process group each rank returns its share of the global batch's
loss (JAX ``losses/rmi.py`` on the mesh's global view), so that the ranks'
mean is the global loss and DDP's mean of their gradients its gradient.
RMI needs no global sort: the BCE is the rank's masked sum times the world
size over the global valid count + 1 (the 1 added once, globally: JAX
:121), and the bound is the mean over the rank's images.  The JAX bound is
the mean over the global batch's images (:94), each image's term its own,
and with equal shards (``data/pipeline.py``) that is the mean of the
ranks' means: exact, with no collective.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from contrastiveseg_tpu_torch.parallel import (
    all_reduce_sum,
    count_global,
    distributed,
    world_size,
)

_CLIP_MIN = 1e-6
_POS_ALPHA = 1e-3


def _map_get_pairs(labels: torch.Tensor, probs: torch.Tensor, radius: int):
    """[N, C, H, W] -> two [N, C, r*r, (H-r+1)*(W-r+1)] stacks of the
    shifted windows (map_get_pairs, rmi_loss.py:31-73)."""
    n, c, h, w = labels.shape
    nh, nw = h - (radius - 1), w - (radius - 1)

    def stack(x):
        return torch.stack([x[:, :, y:y + nh, x0:x0 + nw] for y in range(radius)
                            for x0 in range(radius)], dim=2).reshape(n, c, radius * radius, -1)

    return stack(labels), stack(probs)


def _log_det_cholesky(mat: torch.Tensor) -> torch.Tensor:
    """log det by Cholesky, 2 * sum(log(diag(L) + 1e-8)); NaN where the
    factorisation fails."""
    chol, info = torch.linalg.cholesky_ex(mat)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1) + 1e-8).sum(-1)
    return torch.where(info == 0, logdet, torch.nan)


def rmi_lower_bound(onehot: torch.Tensor, probs: torch.Tensor, radius: int = 3,
                    pool_size: int = 3, pool_stride: int = 3, pool_way: int = 0) -> torch.Tensor:
    """``onehot``, ``probs`` [N, C, H, W] -> the scalar bound, summed over
    the classes."""
    if pool_stride > 1:
        pad = pool_size // 2
        if pool_way == 0:
            onehot = F.max_pool2d(onehot, pool_size, pool_stride, pad)
            probs = F.max_pool2d(probs, pool_size, pool_stride, pad)
        elif pool_way == 1:
            onehot = F.avg_pool2d(onehot, pool_size, pool_stride, pad, count_include_pad=False)
            probs = F.avg_pool2d(probs, pool_size, pool_stride, pad, count_include_pad=False)
        else:
            raise NotImplementedError(f"rmi_pool_way {pool_way}")
    half_d = radius * radius
    la, pr = _map_get_pairs(onehot, probs, radius)  # [N, C, d, P]
    la = la - la.mean(-1, keepdim=True)
    pr = pr - pr.mean(-1, keepdim=True)
    la_cov = la @ la.transpose(-1, -2)
    pr_cov = pr @ pr.transpose(-1, -2)
    eye = torch.eye(half_d, device=la.device, dtype=la.dtype)
    pr_cov_inv = torch.linalg.inv_ex(pr_cov + eye * _POS_ALPHA)[0]
    la_pr_cov = la @ pr.transpose(-1, -2)
    appro_var = la_cov - (la_pr_cov @ pr_cov_inv) @ la_pr_cov.transpose(-1, -2)
    rmi_now = 0.5 * _log_det_cholesky(appro_var + eye * _POS_ALPHA)  # [N, C]
    return (rmi_now.mean(0) / float(half_d)).sum()


def rmi_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int, radius: int = 3,
             pool_size: int = 3, pool_stride: int = 3, pool_way: int = 0,
             weight_lambda: float = 0.5, lambda_way: int = 1,
             loss_weight: float = 1.0) -> torch.Tensor:
    """The masked sigmoid BCE (sum over the valid pixels / (their count +
    1)) and the RMI bound, mixed by ``weight_lambda`` (``lambda_way`` 1:
    ``l * bce + (1 - l) * rmi``; 0: ``bce + l * rmi``), times
    ``loss_weight``.  Under a process group the rank's share (module
    docstring)."""
    valid = (labels >= 0) & (labels < num_classes)
    safe = labels.clamp(0, num_classes - 1).long()
    mask = valid[..., None].float()
    classes = torch.arange(num_classes, device=labels.device)
    onehot = ((safe[..., None] == classes) & valid[..., None]).float()
    logits = logits.float()
    # max(x, 0) - x * z + log1p(exp(-|x|)) in one fused op, which keeps no
    # [N, H, W, C] intermediates for the backward.
    bce = F.binary_cross_entropy_with_logits(logits, onehot, weight=mask, reduction="sum")
    if distributed():
        count_global("rmi")
    bce_loss = bce * world_size() / (all_reduce_sum(valid.sum()) + 1.0)
    probs = torch.sigmoid(logits) * mask + _CLIP_MIN
    rmi = rmi_lower_bound(onehot.permute(0, 3, 1, 2), probs.permute(0, 3, 1, 2), radius,
                          pool_size, pool_stride, pool_way)
    if lambda_way:
        final = weight_lambda * bce_loss + rmi * (1.0 - weight_lambda)
    else:
        final = bce_loss + rmi * weight_lambda
    return loss_weight * final
