"""The plain reference against the port's plain path on the CPU, at tiny
sizes and on the benchmark's own weights: the front end (whole utterances
and chained hops), the dense and block-sparse reservoir with its
statistics and features, the continuous engine's hop with every carried
leaf, the scaler and the readout. The tests may import the port; the
reference may not (test_bench_imports.py)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.lib import corpus, model
from benchmark.loops import port
from benchmark.reference import engines
from lsm_tpu_torch.models import reservoir as res
from lsm_tpu_torch.models.frontend import featurize_batch

BENCH = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(layout: str = "dense", filters: int = 16, neurons: int = 256) -> dict:
    cfg = json.loads((BENCH / "configs" / "flagship.json").read_text())
    cfg["frontend"]["n_filters"] = filters
    cfg["reservoir"].update(layout=layout, num_neurons=neurons, num_output_neurons=64,
                            small_world_k=52)
    return cfg


def test_frontend_batch_equals_featurize_batch():
    cfg = tiny()
    audio = torch.as_tensor(corpus.synthetic_audio_batch(1, 6, seed=5)[0])
    ref = engines.Batch(cfg, model.make(cfg, 1, "cpu"), torch.device("cpu"))
    assert torch.equal(ref.spikes(audio), featurize_batch(audio, port.frontend_config(cfg)))


@pytest.mark.parametrize("layout", ["dense", "block_sparse"])
def test_reservoir_features_and_readout_equal_the_port(layout):
    cfg = tiny(layout)
    w = model.make(cfg, 2**32 + 3, "cpu")
    audio = torch.as_tensor(corpus.synthetic_audio_batch_hard(1, 5, seed=6)[0])
    ref = engines.Batch(cfg, w, torch.device("cpu"), rows=2)
    prog = port.Batch(cfg, w)
    out = prog.step(audio)
    feats = ref.features(out["spikes"])
    torch.testing.assert_close(feats, res.extract_features(prog.reservoir, out["spikes"],
                                                           prog.keys), rtol=0, atol=0)
    assert torch.equal(torch.argmax(ref.logits(feats), -1), out["preds"])
    rec, inp = ref.fired(out["spikes"])
    assert rec > 0 and inp == float(out["spikes"].sum())


@pytest.mark.parametrize("layout", ["dense", "block_sparse"])
def test_stream_hops_equal_the_continuous_engine(layout):
    cfg = tiny(layout)
    w = model.make(cfg, 77, "cpu")
    n = 5
    wire = corpus.to_wire(corpus.synthetic_audio_batch_hard(1, 4, seed=8)[0])
    sched = corpus.StreamSchedule(wire, n, 1600, 30, seed=4)
    prog = port.Serve(cfg, w, n, 1600, 0.1)
    ref = engines.Stream(cfg, w, torch.device("cpu"), 1600, 0.1, rows=n)
    st = ref.init_state(n)
    for h in range(14):
        logits = prog.step(sched.chunk(h))
        st, ref_logits, _, _ = ref.hop(st, torch.as_tensor(sched.chunk(h)))
        np.testing.assert_array_equal(logits, ref_logits.numpy())
        got = prog.state()
        for k in ("iir", "tail", "hyst", "norm_hi", "norm_lo", "v", "refrac", "s_prev", "win_ring"):
            assert torch.equal(got[k], st[k]), (h, k)
        for k, v in got["segs"].items():
            assert torch.equal(v, st["segs"][k]), (h, k)


def test_control_differs_from_the_reference():
    cfg = tiny()
    w = model.make(cfg, 5, "cpu")
    audio = torch.as_tensor(corpus.synthetic_audio_batch(1, 4, seed=2)[0])
    sound = engines.Batch(cfg, w, torch.device("cpu"))
    low = engines.Batch(cfg, w, torch.device("cpu"), lower=True)
    sp = sound.spikes(audio)
    assert not torch.equal(sound.features(sp), low.features(sp))
