"""Data parallelism of the port over ``torch.distributed``.

Counterpart of ``contrastiveseg_tpu/parallel/mesh.py``: the JAX package
shards the batch over a device mesh and jits one global-view program, so
BN statistics, the CE mean, the anchor set and the bank's enqueue are those
of the global batch.  Here each rank is one process on one device
(``torchrun`` launches them) holding a contiguous slice of every global
batch (``data/pipeline.py``); the model runs under ``DistributedDataParallel``
and the global quantities are made by the collectives of this module:

* ``models/layers.BatchNorm2d``: the global batch's statistics at world > 1;
* ``losses/ce.py``: the weighted CE sum over the all-reduced weight sum;
* ``ops/contrast.global_anchor_sample``: one anchor set of the global batch;
* ``engine/train_step.py``: one enqueue of the all-gathered keys, so every
  rank's bank holds the same rows;
* ``engine/evaluator.py``: confusion matrices summed over the ranks.

Without ``torchrun``'s environment no process group exists, every function
here is the identity of one process, and nothing else changes.
"""

from contrastiveseg_tpu_torch.parallel.distributed import (
    all_gather_cat,
    all_reduce_sum,
    barrier,
    data_parallel,
    distributed,
    init_from_env,
    is_main,
    launched,
    rank_and_world,
    refuse_beyond_one_rank,
    require_one_process,
    world_size,
)

__all__ = ["all_gather_cat", "all_reduce_sum", "barrier", "data_parallel", "distributed",
           "init_from_env", "is_main", "launched", "rank_and_world", "refuse_beyond_one_rank",
           "require_one_process", "world_size"]
