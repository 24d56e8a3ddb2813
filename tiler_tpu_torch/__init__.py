"""tiler_tpu_torch: the GTM encoder of ``tiler_tpu`` on PyTorch and CUDA.

A port of the JAX package's encode to torch tensors on one device (an
NVIDIA H100 by default, the CPU when the caller names it, as the tests
do), or on every rank of a torch.distributed group. The JAX package
stays the reference this package is tested against; this package
imports nothing of it and keeps its own copies of the host side.

  config.py  encoder settings (the JAX package's fields and INI keys)
  ops/       colorspaces, DCT features, mirrors, metrics, threefry PRNG
  cluster/   weighted k-means
  kernels/   CUDA kernels (sources in csrc/) beside their plain versions
  pipeline/  the 8 encoder stages + the Encoder facade
  parallel/  device meshes, their collectives, the sharded top-k and k-means
  models/    EncodeState, and its numpy <-> torch conversion
  bitstream/ GTM writer and decoder, LZMA codec (native/ builds lzma.cpp)
  io/        video ingest
  utils/     the synthetic test clip

The reference computes its convolutions and einsums at full float32
(HIGH/HIGHEST precision); TF32 and reduced-precision bf16 reductions are
turned off here so the card computes the same sums.
"""
import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"
