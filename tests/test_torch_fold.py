"""The serving readout's window fold (lsm_tpu_torch/ops/kernels/fold.py) on
the CPU, where the wrapper takes its plain twin: against the statistics of
the whole window's raster, in fold-only mode, in the serving engine, and
the wrapper's refusals. Everything is bit-equal: the fields the features read
are integer-valued (exact in float32), and both sides divide the same
integers. The kernel itself is held against the twin on the card in
tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from lsm_tpu_torch.config import FEATURE_SETS, FrontendConfig, ReservoirConfig
from lsm_tpu_torch.io import dataset
from lsm_tpu_torch.models import reservoir as res
from lsm_tpu_torch.models import sparse
from lsm_tpu_torch.models.continuous import ContinuousKWS
from lsm_tpu_torch.models.streaming import decode_pcm_device
from lsm_tpu_torch.ops.kernels import fold as kfold
from lsm_tpu_torch.ops.kernels.lif import SEG_KEYS
from lsm_tpu_torch.readout import logistic, scaler

# Under pytest-xdist several workers share a few cores; torch's intra-op
# thread pools would contend.
torch.set_num_threads(1)

B, NO, SEG_LEN, N_RING, N_WIN, BURST = 3, 24, 8, 5, 10, 5
WIN_LEN = SEG_LEN * N_RING // N_WIN          # 4 steps a rate window
N_NEW = SEG_LEN // WIN_LEN                   # 2 windows a hop


def _raster(seed):
    """(B, (N_RING + 1) * SEG_LEN, NO) bool: random spikes, plus neuron 0
    silent, neuron 1 an ISI of 1 across the slot 1 | 2 boundary, neuron 2
    an ISI of exactly BURST across a boundary, neuron 3 one of BURST + 1,
    neuron 4 firing only in the oldest segment (silent once it is pushed
    out), neuron 5 firing every step."""
    T = (N_RING + 1) * SEG_LEN
    r = np.random.default_rng(seed).random((B, T, NO)) < 0.2
    r[:, :, :6] = False
    r[:, 2 * SEG_LEN - 1, 1] = r[:, 2 * SEG_LEN, 1] = True
    r[:, 3 * SEG_LEN - 2, 2] = r[:, 3 * SEG_LEN - 2 + BURST, 2] = True
    r[:, 4 * SEG_LEN - 3, 3] = r[:, 4 * SEG_LEN - 2 + BURST, 3] = True
    r[:, 1:SEG_LEN:3, 4] = True
    r[:, :, 5] = True
    return torch.as_tensor(r)


def _summary(raster, s):
    return res.segment_summary(raster[:, s * SEG_LEN:(s + 1) * SEG_LEN], BURST)


def _windows(raster, t0, t1):
    """(B, NO, n) spike counts of the WIN_LEN-step windows of [t0, t1)."""
    x = raster[:, t0:t1].to(torch.float32)
    return x.view(B, (t1 - t0) // WIN_LEN, WIN_LEN, NO).sum(dim=2).transpose(1, 2).contiguous()


def _rings(raster):
    """The engine's state after segments 0..N_RING-1, and the hop's segment
    N_RING with its window counts (B, N_NEW, NO)."""
    sums = [_summary(raster, s) for s in range(N_RING + 1)]
    segs = {k: torch.stack([sm[k] for sm in sums[:N_RING]]) for k in SEG_KEYS}
    win = _windows(raster, 0, N_RING * SEG_LEN)
    win_new = _windows(raster, N_RING * SEG_LEN, (N_RING + 1) * SEG_LEN).transpose(1, 2)
    return segs, win, sums[N_RING], win_new.contiguous()


@pytest.mark.parametrize("feature_set", sorted(FEATURE_SETS))
@pytest.mark.parametrize("seed", [7, 8])
def test_push_equals_the_whole_window(feature_set, seed):
    """After the push the rings hold segments 1..N_RING and the window ring
    the window counts of their steps, and the features equal those of the
    whole window's raster: the ISIs across slot boundaries, the bursts at
    exactly BURST and silent neurons included. CPU tensors take the plain
    twin and launch nothing."""
    keys = tuple(FEATURE_SETS[feature_set])
    raster = _raster(seed)
    segs, win, new_seg, win_new = _rings(raster)
    before = kfold.launches
    pushed, ring, feats = kfold.fold(segs, win, SEG_LEN, BURST, keys, new_seg, win_new)
    assert kfold.launches == before and feats.shape == (B, len(keys) * NO)
    for s in range(N_RING):
        sm = _summary(raster, s + 1)
        assert all(torch.equal(pushed[k][s], sm[k]) for k in SEG_KEYS)
    t0, t1 = SEG_LEN, (N_RING + 1) * SEG_LEN
    assert torch.equal(ring, _windows(raster, t0, t1))
    whole = res.segment_summary(raster[:, t0:t1], BURST)
    whole["win_counts"] = _windows(raster, t0, t1)
    assert torch.equal(feats, res.features_from_stats(whole, keys))
    stats = res.fold_segment_stats(pushed, SEG_LEN, BURST)
    assert stats["bursts"][:, 2].eq(1).all() and stats["n_isi"][:, 3].eq(1).all()
    assert stats["bursts"][:, 3].eq(0).all() and stats["counts"][:, 0:5:4].eq(0).all()


@pytest.mark.parametrize("feature_set", ["original", "all"])
def test_fold_only(feature_set):
    """Without a hop segment the rings come back as they are (the same
    tensors) with their features; the fold of the pushed rings is the
    push's features."""
    keys = tuple(FEATURE_SETS[feature_set])
    segs, win, new_seg, win_new = _rings(_raster(3))
    before = kfold.launches
    same, ring, feats = kfold.fold(segs, win, SEG_LEN, BURST, keys)
    assert same is segs and ring is win
    stats = res.fold_segment_stats(segs, SEG_LEN, BURST)
    stats["win_counts"] = win
    assert torch.equal(feats, res.features_from_stats(stats, keys))
    pushed, pring, pfeats = kfold.fold(segs, win, SEG_LEN, BURST, keys, new_seg, win_new)
    assert torch.equal(kfold.fold(pushed, pring, SEG_LEN, BURST, keys)[2], pfeats)
    assert not torch.equal(feats, pfeats)
    assert kfold.launches == before


def _bad(case):
    segs, win, new_seg, win_new = _rings(_raster(1))
    keys = tuple(FEATURE_SETS["original"])
    if case == "ring_dtype":
        segs["sum_t"] = segs["sum_t"].double()
    elif case == "ring_shapes":
        segs["last"] = segs["last"][:, :, :-1]
    elif case == "no_slot":
        segs = {k: v[:0] for k, v in segs.items()}
    elif case == "missing_ring":
        del segs["bursts"]
    elif case == "window_shape":
        win = win[:, :-1]
    elif case == "window_dtype":
        win = win.double()
    elif case == "segment_without_windows":
        win_new = None
    elif case == "segment_dtype":
        new_seg = dict(new_seg, counts=new_seg["counts"].double())
    elif case == "segment_shape":
        new_seg = dict(new_seg, first=new_seg["first"][:-1])
    elif case == "too_many_windows":
        win_new = torch.zeros(B, N_WIN + 1, NO)
    elif case == "unknown_key":
        keys = ("spike_counts", "spike_rates")
    elif case == "no_key":
        keys = ()
    return segs, win, keys, new_seg, win_new


@pytest.mark.parametrize("case,error", [
    ("ring_dtype", TypeError), ("ring_shapes", ValueError), ("no_slot", ValueError),
    ("missing_ring", ValueError), ("window_shape", ValueError), ("window_dtype", TypeError),
    ("segment_without_windows", ValueError), ("segment_dtype", TypeError),
    ("segment_shape", ValueError), ("too_many_windows", ValueError),
    ("unknown_key", ValueError), ("no_key", ValueError),
])
def test_fold_refuses(case, error):
    segs, win, keys, new_seg, win_new = _bad(case)
    before = kfold.launches
    with pytest.raises(error):
        kfold.fold(segs, win, SEG_LEN, BURST, keys, new_seg, win_new)
    assert kfold.launches == before


def _engine(kind, n_streams=3):
    fcfg = FrontendConfig(n_filters=32)
    cfg = ReservoirConfig(num_neurons=256, num_output_neurons=48, small_world_k=32,
                          mean_weight=0.03, input_fanout=6)
    r = (sparse.init_reservoir_sparse(cfg, fcfg.n_filters) if kind == "sparse"
         else res.init_reservoir(cfg, fcfg.n_filters))
    d = len(FEATURE_SETS["all"]) * r.n_outputs
    rng = np.random.default_rng(4)
    ro = logistic.LogisticReadout(torch.as_tensor(rng.normal(0, 0.1, (d, 5)).astype(np.float32)),
                                  torch.zeros(5))
    sc = scaler.Scaler(torch.as_tensor(rng.random(d).astype(np.float32)),
                       torch.as_tensor((rng.random(d) + 0.5).astype(np.float32)))
    return ContinuousKWS(r, ro, sc, fcfg, "all", n_streams=n_streams)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_engine_hop_equals_the_op_by_op_path(kind):
    """Each hop pushes the reservoir's segment and window counts onto the
    rings (the oldest slot and windows dropped), its logits are the readout
    of the plain twin's features of the pushed rings, and features()
    returns the features behind the last step()."""
    kws = _engine(kind)
    before = kfold.launches
    audio, _ = dataset.synthetic_audio_batch_hard(1, 3, seed=11)
    wire = (np.clip(audio[:, :4800], -1, 1) * 32767).astype(np.int16)
    sc, ro = kws.scaler_state, kws.readout
    for c in range(3):
        chunk = np.ascontiguousarray(wire[:, c * 1600:(c + 1) * 1600])
        st = kws.state
        spikes = kws._featurize(decode_pcm_device(torch.as_tensor(chunk)), st)[0]
        new_seg, win_new = kws._reservoir_chunk(spikes, st)[3:]
        logits = kws.step(chunk)
        segs, win, n = kws.state.segs, kws.state.win_ring, win_new.shape[1]
        for k in SEG_KEYS:
            assert torch.equal(segs[k][:-1], st.segs[k][1:]) and torch.equal(segs[k][-1],
                                                                               new_seg[k])
        assert torch.equal(win[..., :-n], st.win_ring[..., n:])
        assert torch.equal(win[..., -n:], win_new.transpose(1, 2))
        feats = kfold.fold_plain(segs, win, kws._t_c, kws.reservoir.burst_isi_max, kws.keys)[2]
        assert np.array_equal(logits, ((feats - sc.mean) / sc.scale @ ro.w + ro.b).numpy())
        assert np.array_equal(kws.features(), feats.numpy())
    assert kws.state.segs["counts"].sum() > 0 and kfold.launches == before
