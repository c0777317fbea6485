"""The dense B2/B4 plan (`lif.dense_plan`): which body a shape gets, and the
cluster body's tiling, on the CPU. The plan is pure given how many clusters
the card holds at once and a CTA's shared memory at M streams, both of
which the card's library answers (tests/test_torch_kernels.py holds those
answers and the kernels on the card); these tests pass them in."""

import pytest
import torch

from lsm_tpu_torch.ops import _build
from lsm_tpu_torch.ops.kernels import lif as klif

torch.set_num_threads(1)


def h100_like(k, threads, smem):
    """Clusters of k CTAs at one CTA an SM on 132 SMs in GPCs of 16-18."""
    return {16: 7, 8: 16}.get(k, 132 // k)


def layout(n_pad, channels, m):
    """A CTA's shared memory at m streams a round, as csrc/lif.cu lays it
    out: barriers, the W_rec and W_in slices (128 bytes a row, channels
    rounded up to 32), two spike buffers, 32 steps of input words and a
    16-bit source list a stream."""
    nw, cw = n_pad // 32, -(-channels // 32)
    return 16 + 128 * n_pad + 4096 * cw + 8 * m * nw + 128 * m * cw + 2 * m * max(n_pad, 32 * cw)


def plan_for(batch, channels, n_pad, refractory, co=h100_like, body=None):
    return klif.dense_plan(batch, channels, n_pad, refractory, co, layout, body)


@pytest.mark.parametrize("batch,channels,n_pad,refractory,body,k", [
    (256, 128, 1024, 2, klif.CLUSTER, 16),       # the flagship batch (B2)
    (1024, 128, 1024, 2, klif.CLUSTER, 16),      # flagship serving (B4)
    (2400, 128, 1024, 2, klif.CLUSTER, 16),      # the hot path
    (64, 128, 1024, 300, klif.CLUSTER, 16),      # any refractory on the cluster body
    (5, 32, 384, 2, klif.CLUSTER, 6),            # K = 6, not a power of two
    (3, 256, 128, 2, klif.CLUSTER, 2),           # C > N_pad with slices that fit
    (1, 512, 1024, 2, klif.CLUSTER, 16),         # W_in of 64 KB: fewer streams a round
    (5, 2048, 1024, 2, klif.ONE_THREAD, 0),      # redundancy 16: W_in 256 KB a CTA
    (4, 128, 64, 2, klif.ONE_THREAD, 0),         # K = 1: no cluster
    (4, 128, 96, 2, klif.ONE_THREAD, 0),         # N_pad not a multiple of 64
    (4, 128, 1152, 2, klif.BLOCK, 0),            # above 1024 padded neurons
    (4, 128, 4096, 300, klif.BLOCK, 0),
])
def test_dense_plan_picks_the_body(batch, channels, n_pad, refractory, body, k):
    plan = plan_for(batch, channels, n_pad, refractory)
    assert plan.body == body
    assert plan.cluster_size == k
    if body == klif.CLUSTER:
        assert plan.cluster_size * klif.CLUSTER_SLICE == n_pad
    else:
        assert plan.c_args()[1:] == (0,) * 5


@pytest.mark.parametrize("batch", [1, 7, 16, 64, 112, 113, 256, 1000, 1024, 2400])
@pytest.mark.parametrize("n_pad,channels", [(1024, 128), (384, 32), (128, 256), (1024, 512)])
def test_cluster_tiling_covers_the_batch(batch, n_pad, channels):
    plan = plan_for(batch, channels, n_pad, 2)
    assert plan.body == klif.CLUSTER
    assert 1 <= plan.streams <= klif.MAX_CLUSTER_STREAMS
    assert plan.threads == 32 * plan.streams
    assert plan.smem_bytes == layout(n_pad, channels, plan.streams)
    assert plan.smem_bytes <= 232_448
    assert 1 <= plan.clusters <= plan.co_resident
    assert plan.streams * plan.clusters * plan.rounds >= batch
    # No round is wasted: one round fewer could not hold the batch.
    assert plan.streams * plan.clusters * (plan.rounds - 1) < batch
    # The kernel walks rounds first, first + clusters * M, ...: the busiest
    # cluster takes `rounds` of them.
    assert -(-(-(-batch // plan.streams)) // plan.clusters) == plan.rounds


def test_flagship_plans():
    """The flagship shapes on a card that holds 7 clusters of 16: B = 64
    (the slices' batch) takes one round of 10 streams, B = 256 two of 19."""
    small = plan_for(64, 128, 1024, 2)
    assert (small.streams, small.clusters, small.rounds) == (10, 7, 1)
    full = plan_for(256, 128, 1024, 2)
    assert (full.streams, full.clusters, full.rounds, full.threads) == (19, 7, 2, 608)
    # barriers, W_rec and W_in slices, spike words, input words, source lists
    assert full.smem_bytes == 16 + 131_072 + 16_384 + 8 * 19 * 32 + 4 * 32 * 19 * 4 + 2 * 19 * 1024


def test_dense_plan_asks_the_card_at_the_largest_round():
    asked = []

    def co(k, threads, smem):
        asked.append((k, threads, smem))
        return 8

    plan = plan_for(5, 128, 1024, 2, co)
    assert asked == [(16, 768, layout(1024, 128, 24))]
    assert (plan.streams, plan.clusters, plan.rounds) == (1, 5, 1)


@pytest.mark.parametrize("fit,body,cap", [
    (24, klif.CLUSTER, 24),    # every round size fits: the largest, 24
    (5, klif.CLUSTER, 5),      # the layout fills an SM at 5 streams
    (1, klif.CLUSTER, 1),
    (0, klif.ONE_THREAD, 0),   # not one stream's slices fit
])
def test_the_layout_it_is_given_caps_the_round(fit, body, cap):
    """M's cap and the bytes asked for come from the layout function alone:
    here one that reaches the shared-memory limit at `fit` streams."""
    asked = []

    def tight(n_pad, channels, m):
        return klif.SMEM_LIMIT + 1000 * (m - fit)

    def co(k, threads, smem):
        asked.append((threads, smem))
        return 7

    plan = klif.dense_plan(1000, 128, 1024, 2, co, tight)
    assert plan.body == body
    assert plan.streams <= cap
    if body == klif.CLUSTER:
        assert asked == [(32 * cap, tight(1024, 128, cap))]
        assert plan.smem_bytes == tight(1024, 128, plan.streams) <= klif.SMEM_LIMIT
        assert plan.streams * plan.clusters * plan.rounds >= 1000
    else:
        assert asked == []


@pytest.mark.parametrize("n_pad,refractory,match", [
    (4160, 2, "N_pad % 128"),            # past 4096 too: the block body's blocks
    (8256, 2, "N_pad % 128"),
    (1000, 2, "N_pad % 32"),             # not a multiple of 32
    (2048, 65536, "refractory"),         # the block body's 16-bit counter
    (1088, 2, "N_pad % 128"),            # the block body's 128-neuron blocks
])
def test_dense_plan_refuses_what_no_body_takes(n_pad, refractory, match):
    with pytest.raises(ValueError, match=match):
        plan_for(4, 128, n_pad, refractory)


@pytest.mark.parametrize("channels,n_pad,body,ok", [
    (128, 1024, klif.ONE_THREAD, True),   # the reference the cluster body is held to
    (128, 1024, klif.CLUSTER, True),
    (2048, 1024, klif.CLUSTER, False),    # its slices do not fit
    (128, 1024, klif.BLOCK, False),
    (128, 2048, klif.ONE_THREAD, False),
    (128, 2048, "wide", False),
])
def test_dense_plan_takes_a_body_only_where_it_runs(channels, n_pad, body, ok):
    if ok:
        assert plan_for(8, channels, n_pad, 2, body=body).body == body
    else:
        with pytest.raises(ValueError):
            plan_for(8, channels, n_pad, 2, body=body)


def test_a_card_without_room_for_the_cluster_refuses():
    with pytest.raises(ValueError, match="no cluster"):
        plan_for(8, 128, 1024, 2, lambda k, threads, smem: 0)


def test_cpu_tensors_take_the_twin_whatever_the_plan():
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(2, 32, 40, generator=g) < 0.3).to(torch.uint8)
    w_rec = (torch.randn(128, 128, generator=g) * 0.05).to(torch.bfloat16)
    w_in = (torch.randn(32, 128, generator=g) * 0.3).to(torch.bfloat16)
    kw = dict(threshold=1.0, refractory=2, burst_isi_max=5, n_outputs=64, n_win=4)
    plan = plan_for(2, 32, 128, 2)
    before = _build.launches.copy()
    out = klif.lif_stats(x, w_rec, w_in, torch.ones(128), **kw, plan=plan)
    ref = klif.lif_stats_plain(x, w_rec, w_in, torch.ones(128), **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert _build.launches == before
