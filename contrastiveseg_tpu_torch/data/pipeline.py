"""Host-side input pipeline: sample -> augment -> normalize -> collate, with
background prefetch.  It yields numpy batches; pinning them and copying them
to the device is the trainer's (``engine/prefetch.py``).

The port's copy of ``contrastiveseg_tpu/data/pipeline.py``, which replaces
the reference's torch DataLoader + DistributedSampler
(lib/datasets/data_loader.py:81-146).  Rank and world size come from
``torch.distributed`` when it is initialised (0 and 1 otherwise,
``parallel.rank_and_world``): each rank makes its contiguous slice of every
global batch or, with ``microbatches`` A > 1 (``solver.grad_accum_steps``),
its slice of each of the A microbatches of the global batch, so that the
ranks' microbatch i together are the JAX step's rows [i*G/A, (i+1)*G/A).
Every sample of a split counts exactly once over the ranks: a training
epoch drops the samples past the last full global batch, and an evaluation
epoch deals them out one a rank in turn.

Parallelism (`data.workers`, the reference's DataLoader num_workers): a
thread pool, not processes.  The hot aug kernels (bicubic window resize,
nearest resize, normalize: native/segdata.cpp) are ctypes calls that release
the GIL, and numpy's bulk ops do too, so threads scale across host cores
without the fork hazards or the 60 MB/batch IPC copies of a process pool.
Batch RNG is derived per batch index (SeedSequence (base, b)), so the
produced stream is IDENTICAL for any worker count, including 0, and a run
resumed at step s starts at batch ``divmod(s, len(pipeline))`` of the same
stream (``iter_from``).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional

import numpy as np

from contrastiveseg_tpu_torch.data.collate import collate
from contrastiveseg_tpu_torch.data.datasets import build_dataset
from contrastiveseg_tpu_torch.data.transforms import Compose, Normalizer, build_train_transforms
from contrastiveseg_tpu_torch.parallel import rank_and_world


def in_background(items: Iterable, maxsize: int) -> Iterator:
    """``items``, produced on a thread of its own at most ``maxsize`` ahead.
    Closing the iterator stops the thread, after the item in hand, and
    closes ``items``; an exception of the thread is raised here."""
    q: queue.Queue = queue.Queue(maxsize=maxsize)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        it = iter(items)
        try:
            for item in it:
                if not put(("item", item)):
                    return
            put(("end", None))
        except Exception as e:  # handed to the consumer, which raises it
            put(("error", e))
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            kind, item = q.get()
            if kind == "end":
                return
            if kind == "error":
                raise item
            yield item
    finally:
        stop.set()
        t.join()


class DataPipeline:
    def __init__(
        self,
        dataset,
        batch_size: int,
        transforms: Optional[Compose] = None,
        normalizer: Optional[Normalizer] = None,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        collate_kwargs: Optional[dict] = None,
        num_shards: int = 1,
        shard_index: int = 0,
        prefetch: int = 2,
        num_workers: int = 0,
        microbatches: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.transforms = transforms
        self.normalizer = normalizer or Normalizer()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.collate_kwargs = collate_kwargs or {
            "size_mode": "fix_size",
            "input_size": (1024, 512),
            "align_method": "only_pad",
            "pad_mode": "random",
        }
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.num_workers = max(0, min(int(num_workers), 32))
        self.microbatches = microbatches
        if batch_size % microbatches:
            raise ValueError(f"a rank's batch of {batch_size} does not split into "
                             f"{microbatches} microbatches")

    def _shard_len(self) -> int:
        """The number of samples ``_epoch_indices`` gives this shard."""
        G = self.batch_size * self.num_shards
        full, rest = divmod(len(self.dataset), G)
        n = full * self.batch_size
        if not self.drop_last:
            n += len(range(self.shard_index, rest, self.num_shards))
        return n

    def __len__(self) -> int:
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        if self.shuffle and hasattr(self.dataset, "balanced_indices"):
            # Multi-dataset balanced sampler (multi_dataset_loader.py:124).
            idx = self.dataset.balanced_indices(epoch, self.seed)
        else:
            idx = np.arange(len(self.dataset))
            if self.shuffle:
                # Same permutation on every rank; each rank takes its slice.
                np.random.default_rng(self.seed + epoch).shuffle(idx)
        if self.num_shards == 1:
            return idx
        # Per-batch CONTIGUOUS rank slices: global batch b is
        # idx[b*G:(b+1)*G] and rank p owns rows [p*L:(p+1)*L] of it, so the
        # ranks' batches stacked in rank order are the single-process stream.
        # With A microbatches rank p owns rows [p*L/A:(p+1)*L/A] of each.
        L, S, A = self.batch_size, self.num_shards, self.microbatches
        G = L * S
        nb = len(idx) // G
        head = idx[: nb * G].reshape(nb, A, S, L // A)[:, :, self.shard_index].reshape(-1)
        if self.drop_last:  # every rank takes the same number of batches
            return head
        # The rest, one a rank in turn: each sample once over the ranks.
        tail = idx[nb * G :][self.shard_index :: S]
        return np.concatenate([head, tail])

    def _make_batch(self, indices, rng: np.random.Generator) -> dict:
        # Under only_pad + fix-shape modes, uint8 images skip the eager
        # normalize: collate's fused native path normalizes+pads them
        # straight into the batch canvas (bit-identical, zero copies).
        defer_norm = (
            self.collate_kwargs.get("align_method", "only_pad") == "only_pad"
            and self.collate_kwargs.get("size_mode", "fix_size")
            != "diverse_size"
        )
        samples = []
        for i in indices:
            s = self.dataset[int(i)]
            if self.transforms is not None:
                s = self.transforms(s, rng)
            s = dict(s)
            if not (defer_norm and s["image"].dtype == np.uint8):
                s["image"] = self.normalizer(s["image"])
            samples.append(s)
        batch = collate(
            samples, rng=rng,
            normalizer=self.normalizer if defer_norm else None,
            **self.collate_kwargs)
        if isinstance(batch["image"], list):  # diverse_size: per-image eval
            batch["image"] = [x.astype(np.float32, copy=False)
                              for x in batch["image"]]
            if "label" in batch:
                batch["label"] = [x.astype(np.int32, copy=False)
                                  for x in batch["label"]]
            return batch
        if "label" in batch:
            batch["label"] = batch["label"].astype(np.int32, copy=False)
        batch["image"] = batch["image"].astype(np.float32, copy=False)
        return batch

    def epoch_iter(self, epoch: int, start: int = 0) -> Iterator[dict]:
        """Batches ``start``, ``start + 1``, ... of ``epoch``.  Closing the
        iterator early stops its worker threads."""
        indices = self._epoch_indices(epoch)
        nb = len(indices) // self.batch_size if self.drop_last else -(
            -len(indices) // self.batch_size
        )
        base = (self.seed + epoch) * 1000003 + self.shard_index

        def batch_rng(b: int) -> np.random.Generator:
            # Random-access per-batch stream: the same batch index always
            # yields the same augmentations, for ANY worker count.
            return np.random.default_rng(np.random.SeedSequence((base, b)))

        def make(b: int) -> dict:
            chunk = indices[b * self.batch_size : (b + 1) * self.batch_size]
            return self._make_batch(chunk, batch_rng(b))

        if self.num_workers >= 2:
            with ThreadPoolExecutor(self.num_workers) as pool:
                inflight: deque = deque()
                ahead = self.num_workers + self.prefetch
                nxt = start
                try:
                    while nxt < min(start + ahead, nb):
                        inflight.append(pool.submit(make, nxt))
                        nxt += 1
                    while inflight:
                        item = inflight.popleft().result()
                        if nxt < nb:
                            inflight.append(pool.submit(make, nxt))
                            nxt += 1
                        yield item
                finally:
                    for f in inflight:
                        f.cancel()
            return

        yield from in_background((make(b) for b in range(start, nb)), self.prefetch)

    def iter_from(self, step: int = 0) -> Iterator[dict]:
        """Endless batches over epochs (the reference trains by iters),
        starting at global batch ``step``: epoch ``step // len(self)``, batch
        ``step % len(self)``."""
        if len(self) == 0:
            raise ValueError(
                f"the pipeline has no full batch: {len(self.dataset)} samples, "
                f"batch {self.batch_size}, {self.num_shards} shards")
        epoch, b = divmod(step, len(self))
        while True:
            yield from self.epoch_iter(epoch, start=b)
            epoch, b = epoch + 1, 0


def build_pipeline(cfg, split: str = "train", dataset=None) -> DataPipeline:
    dataset = dataset or build_dataset(cfg, split)
    section = "train" if split == "train" else split
    trans_section = "train_trans" if split == "train" else "val_trans"
    td = cfg.get(f"{section}.data_transformer", default={})
    collate_kwargs = {
        "size_mode": td.get("size_mode", "fix_size"),
        "input_size": tuple(td.get("input_size", (1024, 512))),
        "align_method": td.get("align_method", "only_pad"),
        "pad_mode": td.get("pad_mode", "random"),
    }
    if "ms_input_size" in td:
        collate_kwargs["ms_input_size"] = td["ms_input_size"]
    if "fit_stride" in td:
        collate_kwargs["fit_stride"] = td["fit_stride"]
    norm = cfg.get("normalize", default={})
    # `{section}.batch_size` is the GLOBAL batch; each rank produces its
    # 1/world slice.  Mirrors the reference's `batch_size // world_size`
    # (lib/datasets/data_loader.py:137-138).
    rank, world = rank_and_world()
    global_bs = cfg.get(f"{section}.batch_size", default=8)
    if global_bs % world != 0:
        raise ValueError(
            f"{section}.batch_size={global_bs} not divisible by "
            f"world size {world}")
    workers = cfg.get("data.workers", default=0)
    return DataPipeline(
        dataset,
        batch_size=global_bs // world,
        transforms=build_train_transforms(cfg, trans_section),
        normalizer=Normalizer(
            div_value=norm.get("div_value", 255.0),
            mean=norm.get("mean_value", (0.485, 0.456, 0.406)),
            std=norm.get("std", (0.229, 0.224, 0.225)),
        ),
        shuffle=split == "train",
        drop_last=split == "train",
        collate_kwargs=collate_kwargs,
        num_shards=world,
        shard_index=rank,
        num_workers=workers // world if world > 1 else workers,
        microbatches=(cfg.get("solver.grad_accum_steps", default=1)
                      if split == "train" else 1),
    )
