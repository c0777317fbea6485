"""The serving engines' chunk placement (models/streaming.py `place_chunk`
and `IngestSlots`). On the CPU: a CPU engine places host chunks as they
are and counts them `direct`, tensors count `tensor`, every refusal keeps
its text, how the staging copy splits over host threads, and the native
staging copy itself (ops/stage.py) against np.copyto. On the card (marked gpu):
host chunks through an engine's page-locked slots give the logits and
every carried-state leaf of the same chunks placed as device tensors, bit
for bit, on the int16, float32 and mu-law wires, for both engines, under
`stream(depth=3)`, and with the caller's array overwritten as soon as the
engine has it; the slots are allocated once.

This file imports no jax and nothing of lsm_tpu, so it also runs where jax
is not installed:

    python -m pytest --noconftest -q tests/test_torch_ingest.py
"""

import numpy as np
import pytest
import torch

from lsm_tpu_torch.config import FEATURE_SETS, FrontendConfig, ReservoirConfig
from lsm_tpu_torch.io import dataset
from lsm_tpu_torch.models import reservoir as res
from lsm_tpu_torch.models import streaming as tstr
from lsm_tpu_torch.models.continuous import ContinuousKWS
from lsm_tpu_torch.models.streaming import IngestSlots, StreamingKWS
from lsm_tpu_torch.ops import stage
from lsm_tpu_torch.ops.ulaw import encode_ulaw_f32
from lsm_tpu_torch.readout import logistic, scaler

# Under pytest-xdist several workers share a few cores.
torch.set_num_threads(1)

N, L, HOPS, K = 8, 1600, 6, 12
WIRES = ("int16", "float32", "uint8")
KINDS = ("continuous", "exact")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the page-locked slots exist only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def audio():
    a, _ = dataset.synthetic_audio_batch_hard(1, N, seed=4)
    return np.concatenate([a[:N], a[::-1][:N]], axis=1)[:, :(HOPS + 2) * L]


def engine(kind, device, n=N):
    fcfg = FrontendConfig(n_filters=16)
    r = res.init_reservoir(ReservoirConfig(num_neurons=128, num_output_neurons=32),
                           fcfg.n_filters, mean_weight=0.02, device=device)
    d = len(FEATURE_SETS["original"]) * r.n_outputs
    rng = np.random.default_rng(7)
    ro = logistic.LogisticReadout(
        torch.as_tensor(rng.normal(0, 0.1, (d, K)).astype(np.float32)).to(device),
        torch.zeros(K, device=device))
    sc = scaler.Scaler(torch.as_tensor(rng.random(d).astype(np.float32)).to(device),
                       torch.as_tensor((rng.random(d) + 0.5).astype(np.float32)).to(device))
    if kind == "exact":
        return StreamingKWS(r, ro, sc, fcfg, "original", n)
    return ContinuousKWS(r, ro, sc, fcfg, "original", n, chunk_len=L)


def wire(x, name):
    if name == "int16":
        return np.clip(x * 32768.0, -32768.0, 32767.0).astype(np.int16)
    if name == "uint8":
        return encode_ulaw_f32(x)
    return np.asarray(x, np.float32)


def hops(audio, name, lens=None):
    """HOPS distinct chunks of the wire `name` (lengths `lens` for the
    exact engine, L each by default)."""
    lens = lens or [L] * HOPS
    ends = np.cumsum(lens)
    return [wire(audio[:, e - n:e], name) for n, e in zip(lens, ends)]


def counts():
    return dict(tstr.ingest_counts)


def grew(before, key):
    return tstr.ingest_counts[key] - before.get(key, 0)


# ---- the CPU: the plain path, its counts, its refusals ---------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", WIRES)
def test_cpu_engine_places_host_chunks_directly(audio, kind, name):
    a, b = engine(kind, "cpu"), engine(kind, "cpu")
    chunks = hops(audio, name)[:3]
    before = counts()
    host = [a.step(c) for c in chunks]
    assert grew(before, "direct") == 3
    assert (grew(before, "staged"), grew(before, "slot_allocs"), grew(before, "tensor")) == (0, 0, 0)
    before = counts()
    for c, want in zip(chunks, host):
        np.testing.assert_array_equal(b.step(torch.as_tensor(c)), want)
    assert (grew(before, "tensor"), grew(before, "direct")) == (3, 0)
    for k, v in a.snapshot().items():
        np.testing.assert_array_equal(b.snapshot()[k], v, err_msg=k)


@pytest.mark.parametrize("kind,chunk,err,match", [
    ("continuous", np.zeros((N + 1, L), np.float32), ValueError, f"expected {N} streams, got {N + 1}"),
    ("continuous", np.zeros((N, L - 1), np.float32), ValueError,
     f"continuous mode ingests fixed {L}-sample chunks, got {L - 1}"),
    ("continuous", np.zeros((N, L), np.int32), TypeError,
     "integer PCM chunks must be int16 \\(linear\\) or uint8 \\(mu-law\\), got int32"),
    ("exact", np.zeros((N, 16001), np.int16), ValueError,
     "chunk length 16001 exceeds the analysis window \\(16000 samples\\)"),
    ("exact", np.zeros((N - 1, 10), np.uint8), ValueError, f"expected {N} streams, got {N - 1}"),
    ("continuous", torch.zeros(N, L, dtype=torch.float64), ValueError,
     f"a tensor chunk must be \\({N}, {L}\\) float32/int16/uint8 on cpu, got "
     f"torch.float64\\({N}, {L}\\) on cpu"),
    ("continuous", torch.zeros(N, L - 1, dtype=torch.int16), ValueError,
     f"a tensor chunk must be \\({N}, {L}\\) float32/int16/uint8 on cpu"),
    ("exact", torch.zeros(N, 0, dtype=torch.int16), ValueError,
     f"a tensor chunk must be \\({N}, 1..16000\\) float32/int16/uint8 on cpu"),
    ("exact", torch.zeros(1, N, 10), ValueError, "a tensor chunk must be"),
])
def test_refusals_keep_their_text_and_count_nothing(kind, chunk, err, match):
    kws = engine(kind, "cpu")
    before = counts()
    with pytest.raises(err, match=match):
        kws.step(chunk)
    assert counts() == before


@pytest.mark.parametrize("rows,nbytes,want", [
    (4096, 4096 * 1600 * 2, 6),               # flagship.serve's hop, 13.1 MB
    (8192, 8192 * 1600 * 2, 12),              # a flagship-dp4.serve rank's, 26.2 MB
    (1024, 1024 * 1600 * 2, 1),               # scaled10k.serve's, 3.3 MB: one copy
    (8, 8 * 1600 * 4, 1),
    (3, 64 << 20, 3),                         # never more blocks than rows
    (100000, 1 << 30, 64),                    # nor more than STAGE_BLOCKS
    (1, 0, 1),
])
def test_ingest_blocks(rows, nbytes, want):
    assert tstr.ingest_blocks(rows, nbytes) == want


def test_staging_threads_share_the_cores():
    assert 1 <= tstr.staging_threads() <= tstr.STAGE_THREADS


# ---- the staging copy (ops/stage.py, csrc/stage.cpp) on the host ----------

@pytest.fixture
def native():
    if not __import__("shutil").which("g++"):
        pytest.skip("g++ is missing: the staging copy builds with it")


def _sources(dtype):
    wide = (np.random.default_rng(2).random((301, 3 * 50)) * 200).astype(dtype)
    return {"contiguous": np.ascontiguousarray(wide[:, :50]), "columns": wide[:, 50:100],
            "reversed": wide[::-1, 100:], "one_column": wide[:, 7:8]}


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float64])
@pytest.mark.parametrize("source", ["contiguous", "columns", "reversed", "one_column"])
@pytest.mark.parametrize("per_block,threads", [(301, 1), (40, 1), (40, 4), (3, 8), (7, 3)])
def test_stage_copy_rows_equals_copyto(native, dtype, source, per_block, threads):
    src = _sources(dtype)[source]
    dst = np.zeros(src.shape, src.dtype)
    n = -(-src.shape[0] // per_block)
    with stage.copy_rows(dst, src, per_block, threads) as landed:
        for b in range(n):
            landed(b)
            rows = slice(b * per_block, (b + 1) * per_block)
            np.testing.assert_array_equal(dst[rows], src[rows])
    np.testing.assert_array_equal(dst, src)


@pytest.mark.parametrize("dst,src,per_block,threads", [
    (np.zeros((4, 5), np.int16), np.zeros((4, 6), np.int16), 1, 1),        # shapes
    (np.zeros((4, 5), np.int16), np.zeros((4, 5), np.float32), 1, 1),      # dtypes
    (np.zeros((4, 5), np.int16), np.zeros((4, 10), np.int16)[:, ::2], 1, 1),  # strided rows
    (np.zeros((5, 4), np.int16).T, np.zeros((4, 5), np.int16), 1, 1),      # destination
    (np.zeros((4, 5), np.int16), np.zeros((4, 5), np.int16), 0, 1),        # no rows a block
    (np.zeros((300, 5), np.int16), np.zeros((300, 5), np.int16), 1, 2),    # 300 blocks
    (np.zeros((4, 5), np.int16), np.zeros((4, 5), np.int16), 1, 0),        # no thread
])
def test_stage_copy_rows_refuses(native, dst, src, per_block, threads):
    with pytest.raises(ValueError, match="cannot stage|staging needs"):
        with stage.copy_rows(dst, src, per_block, threads):
            pass
    ok = np.ones((4, 5), np.int16)
    with stage.copy_rows(np.zeros_like(ok), ok, 1, 2):       # the job lock was not kept
        pass


def test_stage_callers_on_several_threads_take_turns(native):
    """More callers than cores, each staging its own arrays again and again
    through the one process-wide pool: every copy lands whole."""
    import threading

    rng = np.random.default_rng(3)
    srcs = [rng.integers(0, 255, (997, 300)).astype(np.uint8) for _ in range(12)]
    bad = []

    def caller(i):
        dst = np.empty_like(srcs[i])
        for k in range(30):
            dst[...] = 0
            with stage.copy_rows(dst, srcs[i], 31 + k, 1 + (i + k) % 8):
                pass
            if not np.array_equal(dst, srcs[i]):
                bad.append((i, k))

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(len(srcs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


# ---- the card: the page-locked slots ---------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", WIRES)
def test_staged_chunks_equal_device_tensors(cuda, audio, kind, name):
    """step on host chunks against step on the same chunks already on the
    card: logits and every carried-state leaf bit-equal; one staged
    placement a hop; the slots allocated at the first hop only."""
    a, b = engine(kind, cuda), engine(kind, cuda)
    before = counts()
    for h, c in enumerate(hops(audio, name)):
        np.testing.assert_array_equal(a.step(c), b.step(torch.as_tensor(c).to(cuda)))
        assert grew(before, "slot_allocs") == tstr.STAGE_SLOTS, h
    assert (grew(before, "staged"), grew(before, "tensor")) == (HOPS, HOPS)
    assert grew(before, "direct") == 0
    for k, v in b.snapshot().items():
        np.testing.assert_array_equal(a.snapshot()[k], v, err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", WIRES)
def test_stream_depth3_and_a_reused_caller_buffer(cuda, audio, kind, name):
    """stream(depth=3) fed one caller buffer, refilled with the next chunk
    (and every other write garbage) as soon as the engine has taken it,
    against serial step calls on copies: three hops in flight over two
    slots, so a slot written before its copy landed, or a copy read from
    the caller's array after place returned, would show."""
    chunks = hops(audio, name)
    serial = engine(kind, cuda)
    want = [serial.step(c.copy()) for c in chunks]
    piped = engine(kind, cuda)
    buf = np.empty_like(chunks[0])

    def feed():
        for c in chunks:
            buf[...] = c
            yield buf
            buf[...] = chunks[-1][::-1]

    before = counts()
    got = list(piped.stream(feed(), depth=3))
    assert grew(before, "staged") == HOPS
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    step = engine(kind, cuda)
    for c, y in zip(chunks, want):
        buf[...] = c
        out = step.step(buf)
        buf[...] = 0
        np.testing.assert_array_equal(out, y)
    for k, v in serial.snapshot().items():
        np.testing.assert_array_equal(piped.snapshot()[k], v, err_msg=k)
        np.testing.assert_array_equal(step.snapshot()[k], v, err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("name", WIRES)
def test_exact_engine_shorter_chunks(cuda, audio, name):
    """The exact engine's chunks of 1..16000 samples take a (B, L) view of
    one slot of 16000 a stream: bit-equal to device tensors, and one ring
    a wire for every length."""
    lens = [400, 1600, 1, 800, 16000 - 2801, 1600]
    a, b = engine("exact", cuda), engine("exact", cuda)
    long = np.concatenate([audio] * 3, axis=1)
    before = counts()
    for c in hops(long, name, lens):
        np.testing.assert_array_equal(a.step(c), b.step(torch.as_tensor(c).to(cuda)))
    assert grew(before, "slot_allocs") == tstr.STAGE_SLOTS
    np.testing.assert_array_equal(a.snapshot()["buffer"], b.snapshot()["buffer"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.uint8])
def test_slots_place_split_and_strided_chunks(cuda, dtype):
    """IngestSlots.place at sizes copied in several row blocks, from a
    contiguous chunk and from a column slice of a wider array (as
    fit_continuous_readout passes), and from rows that are not contiguous,
    against a plain copy; two dtypes' rings live side by side. The copies queue behind a long kernel, so the third
    chunk finds its slot's copy still in flight and must wait for it
    rather than overwrite it. (The rings are allocated first: allocating
    page-locked memory may wait for the card.)"""
    rng = np.random.default_rng(1)
    wide = (rng.random((4099, 3 * L)) * 200).astype(dtype)
    srcs = (wide[:, L:2 * L], np.ascontiguousarray(wide[:, :L]), wide[:, 2 * L:])
    small = wide[:7, :15].astype(np.float64)[:, ::3]           # rows not contiguous
    slots = IngestSlots(cuda)
    before = counts()
    slots.place(srcs[2], 4099 * L)
    slots.place(small, 7 * 5)
    torch.cuda.synchronize()
    assert grew(before, "slot_allocs") == 2 * tstr.STAGE_SLOTS
    before = counts()
    torch.cuda._sleep(200_000_000)
    outs = []
    for src in srcs:
        assert tstr.ingest_blocks(src.shape[0], src.nbytes) > 1
        outs.append((slots.place(src, 4099 * L), src.copy()))
    other = slots.place(small, 7 * 5)
    torch.cuda.synchronize()
    for out, src in outs:
        assert out.dtype == torch.from_numpy(src).dtype and out.device.type == "cuda"
        np.testing.assert_array_equal(out.cpu().numpy(), src)
    np.testing.assert_array_equal(other.cpu().numpy(), small)
    assert (grew(before, "slot_allocs"), grew(before, "staged")) == (0, 4)
    assert grew(before, "slot_waits") >= 1
