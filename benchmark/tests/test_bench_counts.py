"""The kernels' counts: the function's work as chip_smoke.py counted it, held
against the peak of the unit that can do it, so that no share passes 100 %."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from benchmark.lib import roofline

REPO = Path(__file__).resolve().parents[2]


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_counts", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SHAPE = {"channels": 128, "in_channels": 128, "steps": 400, "neurons": 1000, "outputs": 400,
         "classes": 12, "features": 2000, "width": 1024, "c_pad": 128,
         "weight_bytes": 1024 * 1024 * 2 + 128 * 1024 * 2 + 1024 * 4, "in_fanout": 8.0,
         "state_bytes_per_stream": 180_000}


def batch_run(**kw) -> dict:
    run = {"cell_kind": "batch", "utterances": 4800, "steps": 2, "samples": 16000, "n_sub": 200,
           "shape": dict(SHAPE), "rec_rows_per_utt": 9000.0, "in_rows_per_utt": 4000.0,
           "trace": {"device_s_by_name": {}, "busy_s": 1.0, "window_s": 0.1}}
    run.update(kw)
    return run


def test_counts_are_chip_smokes_counts():
    cs = chip_smoke()
    run = batch_run()
    assert roofline.counts("b1").work(run)["f32"] == cs.gtgram_flops(4800, 128, 16000)
    b2 = roofline.counts("b2").work(run)
    assert b2["tc"] + b2["f32"] == cs.lif_flops(13000.0 * 4800, 4800, 400, 1000)
    serve = {"cell_kind": "serve", "streams": 1024, "hops": 3, "t_c": 40, "n_new_win": 1,
             "chunk_len": 1600, "n_sub": 20, "channels": 128, "rec_rows_per_stream_hop": 90.0,
             "in_rows_per_stream_hop": 300.0,
             "shape": {**SHAPE, "neurons": 10240, "width": 10240, "out_degree": 1020.0}}
    b6 = roofline.counts("b6").work(serve)
    assert b6["tc"] + b6["f32"] == pytest.approx(
        cs.sparse_flops(90.0 * 1024, 300.0 * 1024, 8.0, 1020.0, 1024, 40, 10240) * 3)
    assert roofline.counts("b4").work(serve) is None
    assert roofline.counts("b2").work(serve) is None


def test_peaks_are_the_published_ones():
    p = json.loads((REPO / "benchmark" / "counts" / "peaks.json").read_text())
    assert (p["f32_flops"], p["bf16_tensor_flops"], p["hbm_bytes_per_s"]) == (67e12, 989e12, 3.35e12)


def test_the_adds_go_against_the_tensor_core_peak():
    run = batch_run()
    w = roofline.counts("b2").work(run)
    by_f32 = max((w["tc"] + w["f32"]) / 67e12, w["bytes"] / 3.35e12)
    assert roofline.least_s(w) < by_f32


@pytest.mark.parametrize("kernel", ["b1", "b2"])
def test_no_kernel_or_metric_reads_without_its_time(kernel):
    assert roofline.share(batch_run(), kernel) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: B1 runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_b1_share_on_the_card_is_under_its_roofline(card):
    from benchmark.lib.trace import Profile
    from lsm_tpu_torch.ops import gammatone as gt
    from lsm_tpu_torch.ops.kernels import gtgram as kgt

    fb = gt.filterbank(16000, 128, 50.0, 80, card)
    wave = torch.randn(256, 16000, device=card) * 0.1
    kgt.sub_energy(wave, fb)
    torch.cuda.synchronize()
    with Profile(True) as prof:
        for _ in range(5):
            kgt.sub_energy(wave, fb)
        torch.cuda.synchronize()
    run = batch_run(utterances=256 * 5, steps=5, trace=prof.reduce(1.0))
    share = roofline.share(run, "b1")
    assert share is not None and 0.0 < share <= 100.0
