"""Wrappers of the hand-written CUDA kernels (csrc/*.cu), each beside its
plain PyTorch twin. CPU tensors take the twin; CUDA tensors launch the
kernel or raise. Every launch goes through ops/_build.py's `Entry.launch`,
which counts it in `_build.launches` by C entry point; twins count
nothing."""
