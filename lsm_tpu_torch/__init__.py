"""PyTorch + CUDA port of lsm_tpu's batch classification path (gammatone
or mel frontend), offline inference from WAVs, corpus-scale streaming
training (pipeline.extract_and_train_streaming) and its serving layer: the exact and continuous
streaming engines (models/streaming.py, models/continuous.py), the session
pool (models/pool.py), serving-state files (io/serving_state.py) and the
entry point `python -m lsm_tpu_torch.cli.stream_kws`; with the dense
reservoir (drawn on the device from 4096 neurons on) or the block-sparse
one of the scaled configuration (models/sparse.py). The entry points take
lsm_tpu's --check (utils/checks.py), --metrics-out (utils/logging.py) and
--single-device; models/sweep.py and the operator tools
(`python -m lsm_tpu_torch.tools.<name>`) come with them.
utils/profiling.py holds `span`, a `record_function` range at each layer
boundary while a torch profiler records (`lsm.kws.step` and its ingest,
frontend, reservoir, readout and egress around each serving hop;
`lsm.frontend` and its spectrogram, normalize and encode stages;
`lsm.reservoir`; `lsm.readout`) and nothing otherwise, and
`perfetto_trace(path)`: wrapping any call in it shows the spans beside
the card's kernels and copies in a Perfetto trace. The batch
and training path also runs over several ranks of a process group
(parallel/: data-parallel stages, the tensor-parallel reservoir, the fused
training step), and WAVs decode on a native C++ decoder (csrc/wavio.cpp,
io/native.py) where g++ can build it. A CUDA serving engine stages each
host chunk into page-locked slots on native host threads (csrc/stage.cpp,
ops/stage.py, also built by g++) and sends it to the card in row blocks
ordered on its stream (models/streaming.py `IngestSlots`).

The JAX package `lsm_tpu` is the reference; this package mirrors its
layout (ops/, models/, readout/, pipeline.py) so each module's counterpart
is easy to find. It imports torch and numpy, never jax and nothing of
`lsm_tpu`: the config dataclasses, the synthetic corpora and the artifact
writers it shares with the reference are copies (`config.py`, `io/`) that
the tests hold equal to lsm_tpu's.

The six TPU kernels on these paths are hand-written CUDA C++ for sm_90a
(csrc/gtgram.cu: B1 and its carried-state sibling B3; csrc/lif.cu: B2
and B4; csrc/sparse_lif.cu: B5 and B6), and so are the hysteresis spike
encoder (csrc/hysteresis.cu) and the serving readout's window fold
(csrc/fold.cu), built with nvcc at first use and bound with ctypes
(ops/_build.py, whose `Entry.launch` makes every kernel call and counts
it in `_build.launches` by C entry point). Each wrapper (ops/kernels/)
runs its plain PyTorch twin for CPU tensors and the kernel for CUDA
tensors.
"""
