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
  OHEM's threshold, the k-th smallest true-class probability of the global
  batch (``global_kth_smallest``), and its mean over the global kept count;
* ``losses/rmi.py``: the BCE over the global batch's valid count + 1;
* ``losses/lovasz.py``: each class's errors sorted over the global batch
  (gathered with their gradient);
* ``ops/contrast.global_anchor_sample``: one anchor set of the global batch;
* ``engine/train_step.py``: one enqueue of the all-gathered keys, so every
  rank's bank holds the same rows; the first step's gradient mean, after
  which the parameters that the loss never reaches stay out of DDP's
  reducer (``exclude_unreached``);
* ``models/heads.ASPP``: its image-pool BN trains at one image a rank, on
  the global batch;
* ``engine/evaluator.py``: confusion matrices summed over the ranks.

Without ``torchrun``'s environment no process group exists, every function
here is the identity of one process, and nothing else changes.
"""

from contrastiveseg_tpu_torch.parallel.distributed import (
    all_gather_cat,
    all_reduce_sum,
    barrier,
    count_global,
    data_parallel,
    distributed,
    exclude_unreached,
    global_calls,
    global_kth_smallest,
    init_from_env,
    is_main,
    launched,
    rank_and_world,
    require_one_process,
    reset_global_calls,
    world_size,
)

__all__ = ["all_gather_cat", "all_reduce_sum", "barrier", "count_global", "data_parallel",
           "distributed", "exclude_unreached", "global_calls", "global_kth_smallest",
           "init_from_env", "is_main", "launched", "rank_and_world", "require_one_process",
           "reset_global_calls", "world_size"]
