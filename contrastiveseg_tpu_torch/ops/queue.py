"""Cross-image memory bank (segment + pixel queues).

Counterpart of ``contrastiveseg_tpu/ops/queue.py``, with the same
semantics and documented divergences from the reference trainer
(trainer_contrastive.py:102-138): per (image, class) the segment queue gets
the L2-normalized mean embedding and the pixel queue up to
``pixel_update_freq`` random L2-normalized pixels; pointers advance by the
number of rows written; wraparound is a clean ring; class 0 takes part by
default.

Layout: one flat ``storage`` tensor of ``C * 2M + 1`` rows.  Rows
``[c*2M, c*2M + M)`` are class c's segment queue, ``[c*2M + M, (c+1)*2M)``
its pixel queue, and the last row is a trash row that nothing reads.  The
contrast set (``bank_as_contrast_set``) is then a free view of the first
``C * 2M`` rows, not a concatenation of the two queues on every step.  Only the layout
differs from the JAX package's two [C, M, D] queues, never the values.

``enqueue`` updates the bank in place, under no_grad: it runs after the
backward, so no saved tensor still reads the old rows.  Dead writes (ring
collisions within one batch) go to the trash row, so live row indices are
unique -- index assignment with duplicate indices has no defined order on
CUDA, as in XLA.

One global bank under a process group: the train step gathers the keys
and strided labels of the global batch in rank order and every rank
enqueues them with the same global scores, so every rank makes the same
writes in the same order and the ranks' banks stay equal bit for bit (the
reference's per-rank banks drift apart).  ``parallel.shard_queue`` changes where the JAX package
stores its bank, not what it holds; the 19 x 2 x 5000 x 256 fp32 bank
(195 MB) fits each card, so the port keeps it replicated under either
value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_EPS = 1e-12
_NEG_INF = -1e30


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=_EPS)


@dataclasses.dataclass
class MemoryBank:
    storage: torch.Tensor  # [C*2M + 1, D]: segment rows, pixel rows, trash row
    segment_ptr: torch.Tensor  # [C] int32
    pixel_ptr: torch.Tensor  # [C] int32
    num_classes: int
    memory_size: int

    @property
    def queues(self) -> torch.Tensor:
        """[C, 2, M, D] view: [:, 0] segment queue, [:, 1] pixel queue."""
        C, M = self.num_classes, self.memory_size
        return self.storage[:C * 2 * M].view(C, 2, M, -1)

    @property
    def segment_queue(self) -> torch.Tensor:
        return self.queues[:, 0]

    @property
    def pixel_queue(self) -> torch.Tensor:
        return self.queues[:, 1]


def init_memory_bank(num_classes: int, memory_size: int, dim: int,
                     generator: Optional[torch.Generator] = None,
                     device: torch.device | str = "cpu") -> MemoryBank:
    """Random L2-normalized init (reference HRNet_W48_MEM, nets/hrnet.py:165-171)."""
    C, M = num_classes, memory_size
    storage = _l2norm(torch.randn((C * 2 * M + 1, dim), generator=generator,
                                  device=device))
    return MemoryBank(
        storage=storage,
        segment_ptr=torch.zeros(C, dtype=torch.int32, device=device),
        pixel_ptr=torch.zeros(C, dtype=torch.int32, device=device),
        num_classes=C, memory_size=M)


def bank_from_queues(segment_queue: torch.Tensor, segment_ptr: torch.Tensor,
                     pixel_queue: torch.Tensor,
                     pixel_ptr: torch.Tensor) -> MemoryBank:
    """Pack two [C, M, D] queues (the JAX package's layout) into a bank."""
    C, M, D = segment_queue.shape
    storage = torch.zeros((C * 2 * M + 1, D), dtype=segment_queue.dtype,
                          device=segment_queue.device)
    storage[:C * 2 * M].view(C, 2, M, D).copy_(
        torch.stack([segment_queue, pixel_queue], dim=1))
    return MemoryBank(storage, segment_ptr.to(torch.int32),
                      pixel_ptr.to(torch.int32), C, M)


@torch.no_grad()
def enqueue(
    bank: MemoryBank,
    keys_feat: torch.Tensor,  # [B, N, D] detached embeddings at queue stride
    labels: torch.Tensor,  # [B, N] int labels at queue stride
    pixel_update_freq: int = 10,
    include_class0: bool = True,
    scores: Optional[torch.Tensor] = None,  # [B, C, N] uniform draws
    generator: Optional[torch.Generator] = None,
) -> MemoryBank:
    """Enqueue the whole batch in one shot, in place (see module docstring).

    Per-image ring rows are the exclusive cumulative sum of per-image write
    counts, which reproduces the reference's sequential per-image order.
    """
    C, M = bank.num_classes, bank.memory_size
    B, N, _ = keys_feat.shape
    K = pixel_update_freq
    dev = keys_feat.device
    trash = C * 2 * M
    cls = torch.arange(C, device=dev, dtype=labels.dtype)
    seg_ptr = bank.segment_ptr.long()
    pix_ptr = bank.pixel_ptr.long()

    member = labels[:, None, :] == cls[None, :, None]  # [B, C, N]
    count = member.sum(-1)  # [B, C]
    present = count > 0
    if not include_class0:
        present = present & (cls[None, :] > 0)

    # --- segment queue: per-(image, class) mean embedding.
    mean = torch.einsum("bcn,bnd->bcd", member.to(keys_feat.dtype), keys_feat)
    mean = _l2norm(mean / count.clamp(min=1)[..., None])  # [B, C, D]

    present_i = present.long()
    seg_offset = torch.cumsum(present_i, 0) - present_i  # exclusive
    seg_rows = (seg_ptr[None, :] + seg_offset) % M  # [B, C]
    seg_total = present_i.sum(0)  # [C]
    # Only the last M writes per class survive a wrapping batch; the rest
    # go to the trash row so live indices never collide.
    seg_live = present & (seg_offset >= (seg_total - M)[None, :])
    c_base = torch.arange(C, device=dev)[None, :] * 2 * M
    seg_idx = torch.where(seg_live, c_base + seg_rows, trash)
    bank.storage[seg_idx.reshape(-1)] = mean.reshape(B * C, -1).to(bank.storage.dtype)
    new_seg_ptr = (seg_ptr + seg_total) % M

    # --- pixel queue: up to K random member pixels per (image, class).
    if scores is None:
        scores = torch.rand(member.shape, generator=generator, device=dev)
    scores = torch.where(member, scores, _NEG_INF)
    top_idx = torch.topk(scores, K, dim=-1).indices  # [B, C, K]
    sel_ok = torch.gather(member, 2, top_idx)
    order = torch.argsort((~sel_ok).to(torch.int8), dim=-1, stable=True)
    top_idx = torch.gather(top_idx, -1, order)
    b_ids = torch.arange(B, device=dev)[:, None, None]
    vals = _l2norm(keys_feat[b_ids, top_idx])  # [B, C, K, D]
    k_count = sel_ok.sum(-1) * present_i  # [B, C]
    k_ids = torch.arange(K, device=dev)
    k_valid = k_ids[None, None, :] < k_count[..., None]  # [B, C, K]
    pix_offset = torch.cumsum(k_count, 0) - k_count  # exclusive
    rows = (pix_ptr[None, :, None] + pix_offset[..., None] + k_ids) % M
    pix_total = k_count.sum(0)  # [C]
    flat_pos = pix_offset[..., None] + k_ids  # [B, C, K]
    k_live = k_valid & (flat_pos >= (pix_total - M)[None, :, None])
    pix_idx = torch.where(k_live, c_base[..., None] + M + rows, trash)
    bank.storage[pix_idx.reshape(-1)] = vals.reshape(B * C * K, -1).to(bank.storage.dtype)
    new_pix_ptr = (pix_ptr + pix_total) % M

    bank.segment_ptr = new_seg_ptr.to(torch.int32)
    bank.pixel_ptr = new_pix_ptr.to(torch.int32)
    return bank


def bank_as_contrast_set(
    bank: MemoryBank, include_class0: bool = True
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(segment ++ pixel) queues as a [C*2M, D] contrast set: a view.

    Mirrors ``queue = cat(segment_queue, pixel_queue, dim=1)``
    (loss_contrast_mem.py:216) followed by ``_sample_negative``.
    """
    C, M = bank.num_classes, bank.memory_size
    feats = bank.storage[:C * 2 * M]
    labels = torch.arange(C, dtype=torch.int32,
                          device=feats.device).repeat_interleave(2 * M)
    valid = (labels > 0) if not include_class0 else torch.ones_like(
        labels, dtype=torch.bool)
    return feats, labels, valid
