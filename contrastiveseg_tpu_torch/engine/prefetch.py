"""Host batches to the device: pinned on a thread, copied on a side stream.

Counterpart of ``Trainer._device_prefetch`` in
``contrastiveseg_tpu/engine/trainer.py`` (:226-243), for the numpy batches
of ``data/pipeline.py``.  A thread turns each host batch into tensors and,
for a CUDA device, pins them (``Tensor.pin_memory``), so that neither the
pinning nor the pipeline's queue waits run on the step's thread.  Up to
``depth`` batches are then copied ahead of the one in use, each on a side
``torch.cuda.Stream`` whose copy ends in an event; the consuming stream
waits on that event, and every tensor is marked with ``record_stream`` for
the consuming stream, so that its memory is not reused while the step still
reads it.  Labels arrive as int32 and are widened to int64 on the device,
in the same copy.  ``depth`` 0 copies each batch on the consuming stream
when it is asked for.  On the CPU the tensors are the numpy arrays' memory.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from contrastiveseg_tpu_torch.data.pipeline import in_background

KEYS = ("image", "label")


def _host_tensors(batch: dict, pin: bool) -> dict:
    out = {k: torch.from_numpy(np.ascontiguousarray(batch[k])) for k in KEYS}
    return {k: v.pin_memory() for k, v in out.items()} if pin else out


def _copy(host: dict, device: torch.device) -> dict:
    return {"image": host["image"].to(device, non_blocking=True),
            "label": host["label"].to(device, non_blocking=True).long()}


def device_batches(batches: Iterable[dict], device: torch.device | str,
                   depth: int = 1) -> Iterator[dict]:
    """{"image": float32 NHWC, "label": int64} batches on ``device`` from
    numpy {"image", "label"} ``batches``, ``depth`` of them copied ahead."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def host_tensors():
        it = iter(batches)
        try:
            for batch in it:
                yield _host_tensors(batch, pin=cuda)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    host = in_background(host_tensors(), depth + 1)
    try:
        if not cuda or depth == 0:
            for h in host:
                yield _copy(h, device)
            return
        side = torch.cuda.Stream(device)
        inflight: deque = deque()

        def start_copy(h: dict) -> None:
            with torch.cuda.stream(side):
                dev = _copy(h, device)
                done = torch.cuda.Event()
                done.record(side)
            inflight.append((dev, done))

        for h in host:
            start_copy(h)
            if len(inflight) > depth:
                yield _take(inflight, device)
        while inflight:
            yield _take(inflight, device)
    finally:
        host.close()


def _take(inflight: deque, device: torch.device) -> dict:
    dev, done = inflight.popleft()
    consumer = torch.cuda.current_stream(device)
    consumer.wait_event(done)
    for v in dev.values():
        v.record_stream(consumer)
    return dev
