"""The reduction of the program's spans (lib/spans.py): on hand-made
events, device time goes to the span whose runtime call launched it, idle
device time is split at span boundaries and launches are counted per span;
the per-hop readers fall silent on a program without spans and fail loudly
on a window whose hops do not match the run's; and a tiny traced run on
the CPU counts one `lsm.kws.step` a hop and one `lsm.frontend` a step."""

import pytest
from test_bench_faults import result, tiny_root  # noqa: F401  (the tiny tree)

from benchmark.lib import spans

MAIN, OTHER = 1, 2


def hand_made():
    """A hop [0, 10] on the main thread with ingest [1, 4] and frontend
    [4, 8] inside it; device work [0.5, 2], [6, 12] and [12, 13] launched
    from inside the hop (the first by the hop itself, the second by
    ingest), [13, 14] from outside every span."""
    return {
        "spans": [(0.0, 10.0, "lsm.kws.step", MAIN), (1.0, 4.0, "lsm.kws.ingest", MAIN),
                  (4.0, 8.0, "lsm.kws.frontend", MAIN), (0.0, 1.0, "lsm.elsewhere", OTHER)],
        "calls": [(0.2, "cudaLaunchKernel", 7), (3.0, "cudaMemcpyAsync", 9),
                  (5.0, "cudaStreamSynchronize", 99), (9.0, "cudaLaunchKernelExC", 11),
                  (11.0, "cuLaunchKernel", 13)],
        "device": [(0.5, 2.0, 7), (6.0, 12.0, 9), (12.0, 13.0, 11), (13.0, 14.0, 13)],
    }


def test_device_time_goes_to_the_launching_span():
    red = spans.reduce(hand_made())
    step, ingest, front = (red["spans"][k] for k in
                           ("lsm.kws.step", "lsm.kws.ingest", "lsm.kws.frontend"))
    # [6, 12] ran while frontend was open, but ingest's copy call launched it.
    assert ingest["dev_s"] == pytest.approx(6.0)
    assert front["dev_s"] == 0.0
    assert step["dev_s"] == pytest.approx(1.5 + 1.0)
    assert step["dev_s_total"] == pytest.approx(8.5)
    assert red["outside_dev_s"] == pytest.approx(1.0)
    assert red["early"] == 0 and red["lead_s"] == 0.0 and red["device"] is True


def test_an_idle_stretch_is_split_at_span_boundaries():
    red = spans.reduce(hand_made())
    # The device idles over [0, 0.5] (the hop alone) and [2, 6], which
    # straddles the end of ingest and the start of frontend.
    assert red["spans"]["lsm.kws.step"]["idle_s"] == pytest.approx(0.5)
    assert red["spans"]["lsm.kws.ingest"]["idle_s"] == pytest.approx(2.0)
    assert red["spans"]["lsm.kws.frontend"]["idle_s"] == pytest.approx(2.0)
    assert red["spans"]["lsm.kws.step"]["idle_s_total"] == pytest.approx(4.5)


def test_launches_are_counted_per_span():
    red = spans.reduce(hand_made())
    counts = {k: (v["count"], v["launches"], v["launches_total"]) for k, v in red["spans"].items()}
    # The synchronize is no launch; the driver launch at 11 is outside every span;
    # the other thread's span is not the main thread's.
    assert counts == {"lsm.kws.step": (1, 2, 3), "lsm.kws.ingest": (1, 1, 1),
                      "lsm.kws.frontend": (1, 0, 0)}


def test_an_operation_that_starts_before_its_span_is_early_and_leads_its_call():
    ev = {"spans": [(0.0, 1.0, "lsm.kws.step", MAIN), (2.0, 3.0, "lsm.kws.step", MAIN)],
          "calls": [(2.5, "cudaLaunchKernel", 1)], "device": [(1.5, 1.6, 1)]}
    red = spans.reduce(ev)
    assert red["early"] == 1 and red["lead_s"] == pytest.approx(1.0)


def serve_run(reduction, hops=1):
    return {"cell_kind": "serve", "hops": hops, "trace": {"spans": reduction}}


def test_readers_fall_silent_without_spans_and_fail_on_a_hop_mismatch():
    no_spans = spans.reduce({"spans": [], "calls": [], "device": [(0.0, 1.0, 5)]})
    assert spans.per_unit(serve_run(no_spans), "lsm.kws.ingest", "dev_s") is None
    red = spans.reduce(hand_made())
    assert spans.per_unit(serve_run(red), "lsm.kws.ingest", "dev_s") == pytest.approx(6000.0)
    assert spans.per_unit(serve_run(red), "lsm.kws.step", "launches_total", scale=1.0) == 3
    with pytest.raises(RuntimeError, match="1 lsm.kws.step spans .* 2 hops"):
        spans.per_unit(serve_run(red, hops=2), "lsm.kws.ingest", "dev_s")
    host_only = spans.reduce({**hand_made(), "device": []})
    assert spans.per_unit(serve_run(host_only), "lsm.kws.ingest", "dev_s") is None


@pytest.mark.parametrize("cell,unit,key", [("flagship.serve", "lsm.kws.step", "hops"),
                                           ("flagship.batch", "lsm.frontend", "steps")])
def test_traced_run_counts_one_unit_span_a_hop_or_step(tiny_root, capsys, monkeypatch,  # noqa: F811
                                                       cell, unit, key):
    seen = []
    of_run = spans.of_run

    def keep(run):
        seen.append(run)
        return of_run(run)

    monkeypatch.setattr(spans, "of_run", keep)
    line = result(capsys, tiny_root, cell, trace=1)
    run = seen[0]
    red = run["trace"]["spans"]
    assert red["device"] is False and run[key] > 0
    assert red["spans"][unit]["count"] == run[key]
    if key == "hops":
        for stage in ("ingest", "frontend", "reservoir", "readout", "egress"):
            assert red["spans"][f"lsm.kws.{stage}"]["count"] == run["hops"]
    else:
        for stage in ("spectrogram", "normalize", "encode"):
            assert red["spans"][f"lsm.frontend.{stage}"]["count"] == run["steps"]
    # The card's numbers are not read from a CPU run.
    assert not any(k.endswith(("dev_ms.serve", "idle_ms.serve")) or k == "launches.serve"
                   or k in ("spectrogram_ms.batch", "normalize_ms.batch", "encode_ms.batch")
                   for k in line["metrics"])
