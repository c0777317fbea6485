"""PyTorch + CUDA port of lsm_tpu's batch classification path.

The JAX package `lsm_tpu` is the reference; this package mirrors its
layout (ops/, models/, readout/, pipeline.py) so each module's counterpart
is easy to find. It imports torch and numpy, never jax and nothing of
`lsm_tpu`: the config dataclasses, the synthetic corpora and the artifact
writers it shares with the reference are copies (`config.py`, `io/`) that
the tests hold equal to lsm_tpu's.

The two TPU kernels on the main path are hand-written CUDA C++ for
sm_90a (csrc/gtgram.cu, csrc/lif.cu), built with nvcc at first use and
bound with ctypes (ops/_build.py). Each wrapper runs its plain PyTorch
twin for CPU tensors and the kernel for CUDA tensors.
"""
