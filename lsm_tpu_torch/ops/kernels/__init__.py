"""Wrappers of the hand-written CUDA kernels, each beside its plain
PyTorch twin. CPU tensors take the twin; CUDA tensors launch the kernel or
raise. `launches` counts kernel launches only."""
