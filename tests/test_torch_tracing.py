"""The port's spans (utils/profiling.py) on the CPU: off, `span` is one
shared null context and records nothing; inside a profiler window the
spans nest as the code nests and `perfetto_trace` writes them out; the
serving hop and the batch path give the documented spans in their order,
and tracing changes no result and no carried state by a bit."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lsm_tpu_torch import config as tcfg
from lsm_tpu_torch.io import dataset
from lsm_tpu_torch.models import reservoir as res
from lsm_tpu_torch.models.continuous import ContinuousKWS
from lsm_tpu_torch.models.frontend import featurize_batch
from lsm_tpu_torch.readout import logistic, scaler
from lsm_tpu_torch.utils import profiling
from lsm_tpu_torch.utils.profiling import span

torch.set_num_threads(1)

PORT = Path(profiling.__file__).resolve().parents[1]
N_STREAMS, L, HOPS, K = 3, 1600, 2, 4
FCFG = tcfg.FrontendConfig(n_filters=16)
HOP_STAGES = ["lsm.kws.ingest", "lsm.kws.frontend", "lsm.kws.reservoir",
              "lsm.kws.readout", "lsm.kws.egress"]


def traced_spans(prof) -> list:
    """(name, start, end, parent name) of every `lsm.` span of a profiler
    window, in start order; the parent is the innermost enclosing span."""
    found = sorted((e.start_ns(), -e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("lsm.") and e.device_type().name == "CPU")
    out, stack = [], []
    for start, neg, name in found:
        end = start - neg
        while stack and stack[-1][2] <= start:
            stack.pop()
        assert not stack or end <= stack[-1][2], f"{name} overlaps {stack[-1][0]}"
        out.append((name, start, end, stack[-1][0] if stack else None))
        stack.append((name, start, end))
    return out


def children(spans, parent_start, parent_end, parent) -> list:
    return [n for n, a, b, p in spans if p == parent and parent_start <= a and b <= parent_end]


@pytest.fixture(scope="module")
def modules():
    rcfg = tcfg.ReservoirConfig(num_neurons=128, num_output_neurons=64, small_world_k=16)
    reservoir = res.init_reservoir(rcfg, n_channels=FCFG.n_filters)
    rng = np.random.default_rng(5)
    d = len(tcfg.FEATURE_SETS["original"]) * rcfg.num_output_neurons
    ro = logistic.LogisticReadout(rng.normal(0, 0.1, (d, K)).astype(np.float32),
                                  rng.normal(0, 0.1, K).astype(np.float32))
    sc = scaler.Scaler(rng.random(d).astype(np.float32) * 0.1,
                       (rng.random(d) + 0.5).astype(np.float32))
    return reservoir, ro, sc


@pytest.fixture(scope="module")
def audio():
    a, _ = dataset.synthetic_audio_batch_hard(1, N_STREAMS, seed=3)
    a = np.asarray(a, np.float32).reshape(N_STREAMS, -1)[:, :HOPS * L]
    return np.round(a * 32767.0).astype(np.int16)


def test_span_off_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    assert span("lsm.a") is span("lsm.b") is profiling._OFF
    with span("lsm.before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("lsm.inside") as inner:
            assert inner is not None
    names = [n for n, *_ in traced_spans(prof)]
    assert names == ["lsm.inside"]
    with span("lsm.after") as off:
        assert off is None


def test_nested_spans_nest_and_perfetto_writes_them(tmp_path):
    path = tmp_path / "trace.json"
    with profiling.perfetto_trace(str(path)) as prof:
        with span("lsm.outer"):
            torch.ones(8) + 1
            with span("lsm.inner"):
                torch.ones(8) * 2
            with span("lsm.second"):
                torch.ones(8) - 1
    spans = traced_spans(prof)
    assert [(n, p) for n, _, _, p in spans] == [
        ("lsm.outer", None), ("lsm.inner", "lsm.outer"), ("lsm.second", "lsm.outer")]
    written = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]
               if str(e.get("name", "")).startswith("lsm.")}
    assert set(written) == {"lsm.outer", "lsm.inner", "lsm.second"}
    outer, inner = written["lsm.outer"], written["lsm.inner"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def _engine(modules):
    return ContinuousKWS(*modules, FCFG, "original", n_streams=N_STREAMS, chunk_len=L)


def _hop(engine, kind, chunk):
    if kind == "step":
        return engine.step(chunk)
    if kind == "step_compact":
        return engine.step_compact(chunk)
    idx = np.array([2, 0])
    return engine.step_active(chunk[idx], idx)


@pytest.mark.parametrize("kind", ["step", "step_compact", "step_active"])
def test_serving_hop_spans_and_results(modules, audio, kind):
    plain, traced = _engine(modules), _engine(modules)
    chunks = [audio[:, h * L:(h + 1) * L] for h in range(HOPS)]
    want = [_hop(plain, kind, c) for c in chunks]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = [_hop(traced, kind, c) for c in chunks]
    for a, b in zip(want, got):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)
    for name, leaf in plain._leaves().items():
        assert torch.equal(leaf, traced._leaves()[name]), name
    spans = traced_spans(prof)
    hops = [(a, b) for n, a, b, p in spans if n == "lsm.kws.step"]
    assert len(hops) == HOPS
    assert all(p == "lsm.kws.step" for n, *_, p in spans if n != "lsm.kws.step")
    for a, b in hops:
        assert children(spans, a, b, "lsm.kws.step") == HOP_STAGES


def test_batch_path_spans_and_results(modules, audio):
    reservoir, ro, sc = modules

    def classify():
        sp = featurize_batch(torch.as_tensor(audio[:, :16000]), FCFG)
        feats = res.extract_features(reservoir, sp, tuple(tcfg.FEATURE_SETS["original"]))
        return sp, feats, logistic.predict(ro, scaler.transform(sc, feats))

    want = classify()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = classify()
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    spans = traced_spans(prof)
    assert [(n, p) for n, _, _, p in spans] == [
        ("lsm.frontend", None), ("lsm.frontend.spectrogram", "lsm.frontend"),
        ("lsm.frontend.normalize", "lsm.frontend"), ("lsm.frontend.encode", "lsm.frontend"),
        ("lsm.reservoir", None), ("lsm.readout", None), ("lsm.readout", None)]


def test_the_port_opens_only_the_documented_spans():
    documented = set(re.findall(r"^  (lsm\.[a-z.]+)", profiling.__doc__, flags=re.M))
    opened = set()
    for path in PORT.rglob("*.py"):
        opened |= set(re.findall(r'span\("(lsm\.[a-z.]+)"\)', path.read_text()))
    assert opened == documented
    assert len(documented) == 13      # with lsm.kws.gather, opened on a mesh
