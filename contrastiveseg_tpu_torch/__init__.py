"""ContrastiveSeg on PyTorch and CUDA: the port of ``contrastiveseg_tpu``.

The JAX package beside this one stays the reference; every module here
mirrors its counterpart's name and path (``ops/``, ``models/``,
``losses/``, ``engine/``, ``data/``, ``utils/``) and is held against it by
the ``tests/test_torch_port_*.py`` parity tests.

Rules of the port:
  * torch and numpy only -- no jax, flax or optax, and nothing of the JAX
    package, not even its JAX-free modules: the port carries its own
    copies (``presets.py``, ``utils/config.py``);
  * every Pallas kernel of the JAX package is a hand-written CUDA kernel
    under ``csrc/``, built by ``ops/cuda_lib.py``: K1, the anchor x
    memory-bank InfoNCE (``ops/contrast_cuda.py``); K2, the small-channel
    3x3 conv of ``network.pallas_conv`` (``ops/conv_cuda.py``); K3, the
    fused inference BasicBlock (``ops/block_cuda.py``).  A wrapper takes
    its plain torch version only for CPU tensors; for CUDA tensors it
    launches the kernel or raises;
  * public functions keep the JAX package's layouts (NHWC for ``seg`` and
    ``embed``, ``[B, N, D]`` for the sampler and the enqueue); the model
    runs NCHW inside and permutes once at the ``HRNetSeg`` boundary.
"""

__version__ = "0.1.0"
