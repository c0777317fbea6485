"""Dense reservoirs of 4096 neurons and more in the port (lsm_tpu_torch.
models.reservoir.init_reservoir_device) against lsm_tpu's device draw
(`_init_reservoir_device`) on the CPU.

The draws come from different generators (a torch.Generator against
jax.random), so they are held by structure and statistics: out-degree at
most k/2 and at least k/2 - 30 in every real row (rewired edges that land
on another edge of the row collapse; the mean out-degree of the two draws
within 0.5 %), no self-loops, zero padding, the nonzero weights' mean and
std within 1 % of N(mw, |mw| sqrt(weight_variance)) and of each other, the
share of edges outside the ring band within 0.005 of each other and of
p (1 - k / 2N), `w_in` with exactly `fanout` targets of weight
`input_weight` per channel, and the heterogeneous leak's mean within 2 %
and std within 5 % of the target. The simulation is held bit for bit:
lsm_tpu's draw carried across with `convert.reservoir`, snapped to
multiples of 1/256 with zero leak, gives the same statistics in both
packages (every sum exact in float32)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lsm_tpu import config as jcfg
from lsm_tpu import pipeline as jpipe
from lsm_tpu.models import reservoir as jres
from lsm_tpu.models import sparse as jsp

from lsm_tpu_torch import __main__ as tcli
from lsm_tpu_torch import config as tcfg
from lsm_tpu_torch import convert
from lsm_tpu_torch import pipeline as tpipe
from lsm_tpu_torch.models import reservoir as tres
from lsm_tpu_torch.ops.kernels import lif as klif

torch.set_num_threads(1)

CPU = torch.device("cpu")
KEYS = tuple(jcfg.FEATURE_SETS["all"])
MW = 0.02


def _cfg(mod, n, **kw):
    """The entry points' reservoir at n neurons: k = 0.2 N (cli.build_config)."""
    return mod.ReservoirConfig(num_neurons=n, num_output_neurons=256,
                               small_world_k=int(0.10 * n * 2), mean_weight=MW, **kw)


def _structure(w_rec, w_in, leak, n, c, half):
    w = w_rec[:n, :n]
    nz = w != 0
    rows = np.arange(n)[:, None]
    dist = (np.arange(n)[None, :] - rows) % n
    in_band = nz & (dist >= 1) & (dist <= half)
    wi = w_in[:c]
    return {
        "outdeg": nz.sum(axis=1),
        "selfloops": int(np.trace(nz)),
        "pad_zero": float(np.abs(w_rec[n:]).sum() + np.abs(w_rec[:, n:]).sum()
                          + np.abs(w_in[:, n:]).sum() + np.abs(w_in[c:]).sum()
                          + np.abs(leak[n:]).sum()),
        "w_mean": float(w[nz].mean()),
        "w_std": float(w[nz].std()),
        "rewired_share": 1.0 - float(in_band.sum()) / float(nz.sum()),
        "in_per_ch": np.count_nonzero(wi, axis=1),
        "in_values": np.unique(wi[wi != 0]),
        "leak_mean": float(leak[:n].mean()),
        "leak_std": float(leak[:n].std()),
    }


@functools.lru_cache(maxsize=None)
def _draw_pair(n):
    """Both packages' device draws at n neurons (5000: N % 128 != 0, so
    use_sparse() is false and N_pad = 5120), 128 channels, heterogeneous
    leak; drawn once for every test of this module that reads them."""
    return (tres.init_reservoir(_cfg(tcfg, n, leak_variance_divisor=4.0), 128),
            jres.init_reservoir(_cfg(jcfg, n, leak_variance_divisor=4.0), 128))


@pytest.fixture(scope="module", params=[4096, 5000], ids=["n4096", "n5000"])
def draws(request):
    return (request.param, *_draw_pair(request.param))


def test_dense_draw_matches_reference_statistically(draws):
    n, port, ref = draws
    cfg = _cfg(tcfg, n, leak_variance_divisor=4.0)
    half = cfg.small_world_k // 2
    assert tuple(port.w_rec.shape) == tuple(ref.w_rec.shape) == (tres._round_up(n),) * 2
    assert tuple(port.w_in.shape) == tuple(ref.w_in.shape)
    s = {"port": _structure(port.w_rec.numpy(), port.w_in.numpy(), port.leak.numpy(), n, 128,
                            half),
         "lsm_tpu": _structure(np.asarray(ref.w_rec), np.asarray(ref.w_in),
                               np.asarray(ref.leak), n, 128, half)}
    target_std = MW * np.sqrt(cfg.weight_variance)
    for name, st in s.items():
        print(f"{name}: out-degree {st['outdeg'].min()}..{st['outdeg'].max()} "
              f"(mean {st['outdeg'].mean():.2f}) rewired {st['rewired_share']:.4f} weights "
              f"{st['w_mean']:.6f} +- {st['w_std']:.6f} leak {st['leak_mean']:.6f} +- "
              f"{st['leak_std']:.6f}")
        assert half - 30 <= st["outdeg"].min() <= st["outdeg"].max() <= half
        assert st["selfloops"] == 0 and st["pad_zero"] == 0.0
        assert abs(st["w_mean"] - MW) < 0.01 * MW
        assert abs(st["w_std"] - target_std) < 0.01 * target_std
        assert abs(st["rewired_share"] - cfg.small_world_p * (1 - half / n)) < 0.005
        assert (st["in_per_ch"] == cfg.input_fanout).all()
        np.testing.assert_array_equal(st["in_values"], [cfg.input_weight])
        assert abs(st["leak_mean"] - cfg.leak_coefficient) < 0.02 * cfg.leak_coefficient
        assert abs(st["leak_std"] - cfg.leak_coefficient / 4.0) < 0.05 * cfg.leak_coefficient / 4.0
    p, r = s["port"], s["lsm_tpu"]
    assert abs(p["outdeg"].mean() - r["outdeg"].mean()) < 0.005 * half
    assert abs(p["w_mean"] - r["w_mean"]) < 0.01 * MW
    assert abs(p["w_std"] - r["w_std"]) < 0.01 * target_std
    assert abs(p["rewired_share"] - r["rewired_share"]) < 0.005


def test_dense_draw_is_deterministic_and_leaves_the_host_draw_alone():
    """The device draw is a function of the seed; below 4096 neurons the
    NumPy host draw stays bit-equal to lsm_tpu's."""
    a = _draw_pair(4096)[0]
    b = tres.init_reservoir(_cfg(tcfg, 4096, leak_variance_divisor=4.0), 128)
    assert torch.equal(a.w_rec, b.w_rec) and torch.equal(a.w_in, b.w_in)
    assert torch.equal(a.leak, b.leak)
    cfg = _cfg(tcfg, 256)
    d = tres.init_reservoir_device(cfg, 16)
    assert torch.equal(d.w_rec, tres.init_reservoir_device(cfg, 16).w_rec)
    assert not torch.equal(d.w_rec, tres.init_reservoir_device(
        dataclasses.replace(cfg, seed=7), 16).w_rec)
    small = tres.init_reservoir(cfg, 16)
    ref = jres.init_reservoir(_cfg(jcfg, 256), 16)
    np.testing.assert_array_equal(small.w_rec.numpy(), np.asarray(ref.w_rec))
    np.testing.assert_array_equal(small.w_in.numpy(), np.asarray(ref.w_in))
    assert not torch.equal(d.w_rec, small.w_rec)


@pytest.mark.parametrize("n", [4096, 5000])
def test_reference_device_draw_simulates_bit_equal(n):
    """lsm_tpu's device draw, carried across and snapped to the dyadic grid:
    the port's simulation (B2's plain twin on the CPU) gives lsm_tpu's
    statistics bit for bit and its features at rtol 1e-5 / atol 1e-6 (they
    go through float divisions; tests/test_torch_reservoir.py's rule).
    B = 2, T = 40, C = 128."""
    params = _draw_pair(n)[1]
    q = lambda a: jnp.round(jnp.asarray(a) * 256.0) / 256.0  # noqa: E731
    params = dataclasses.replace(params, w_rec=q(params.w_rec), w_in=q(params.w_in),
                                 leak=jnp.zeros_like(params.leak))
    rng = np.random.default_rng(n)
    spikes = (rng.random((2, 128, 40)) < 0.1).astype(np.uint8)
    ref = jres.simulate_batch(params, jnp.asarray(spikes), matmul_dtype=jnp.bfloat16)
    r = convert.reservoir(params)
    got = tres.simulate_batch(r, torch.as_tensor(spikes))
    assert float(got["all_counts"].sum()) > 0
    for k in ("counts", "sum_t", "sum_t2", "first", "last", "n_isi", "sum_isi",
              "sum_isi2", "bursts", "all_counts"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    win = np.asarray(ref["win_counts"])
    np.testing.assert_array_equal(got["win_sum"].numpy(), win.sum(-1))
    np.testing.assert_array_equal(got["win_sum2"].numpy(), (win * win).sum(-1))
    feats = tres.extract_features(r, torch.as_tensor(spikes), KEYS)
    np.testing.assert_allclose(feats.numpy(),
                               np.asarray(jres.extract_features(params, jnp.asarray(spikes), KEYS)),
                               rtol=1e-5, atol=1e-6)


CHOICES = [
    (dict(num_neurons=4096, sparse=False), "dense_device"),
    (dict(num_neurons=5000), "dense_device"),
    (dict(num_neurons=10240, sparse=False), "dense_device"),
    (dict(num_neurons=10240), "sparse"),
    (dict(num_neurons=1000), "dense_host"),
    (dict(num_neurons=512, sparse=True), "sparse"),
]


class _Picked(Exception):
    pass


def _route(monkeypatch, pcfg, port: bool) -> str:
    """Which draw each package's pipeline picks: the three draws are
    stubbed to name themselves and stop."""
    def stub(name):
        def draw(*a, **k):
            raise _Picked(name)
        return draw

    if port:
        stubs = ((tres, "init_reservoir_device"), (tpipe, "init_reservoir_sparse"),
                 (tres, "watts_strogatz_adjacency"))
        init = lambda: tpipe.init_reservoir(pcfg, 128, 0.01, CPU)  # noqa: E731
    else:
        stubs = ((jres, "_init_reservoir_device"), (jsp, "init_reservoir_sparse"),
                 (jres, "watts_strogatz_adjacency"))
        init = lambda: jpipe._init_reservoir_params(pcfg, 128, 0.01)  # noqa: E731
    for (mod, name), route in zip(stubs, ("dense_device", "sparse", "dense_host")):
        monkeypatch.setattr(mod, name, stub(route))
    with pytest.raises(_Picked) as picked:
        init()
    return str(picked.value)


@pytest.mark.parametrize("kw,route", CHOICES, ids=[f"{c[0]['num_neurons']}-{c[1]}" for c in CHOICES])
def test_pipeline_picks_the_dense_device_draw_where_the_reference_does(kw, route, monkeypatch):
    t = _route(monkeypatch, tcfg.PipelineConfig(reservoir=tcfg.ReservoirConfig(**kw)), True)
    j = _route(monkeypatch, jcfg.PipelineConfig(reservoir=jcfg.ReservoirConfig(**kw)), False)
    assert t == j == route


def test_cli_dense_at_scale_builds_a_dense_reservoir(monkeypatch):
    """`--num-neurons 4096 --dense`, which the port refused before it drew
    dense reservoirs on the device, builds lsm_tpu's config and takes the
    dense device draw."""
    argv = ["--num-neurons", "4096", "--dense", "--n-filters", "16"]
    pcfg = tcli.build_config(tcli.parse_args(argv + ["--device", "cpu"]))
    assert pcfg.reservoir.sparse is False and pcfg.reservoir.small_world_k == 819
    assert _route(monkeypatch, pcfg, True) == "dense_device"


@pytest.mark.parametrize("n_pad", [4224, 5120, 8192, 10240])
def test_dense_plan_takes_the_block_body_above_4096(n_pad):
    """The cap at N_pad 4096 is gone: the block body takes any N_pad % 128
    == 0 above 1024, at any refractory its 16-bit counter holds."""
    never = lambda *a: pytest.fail("the block body asks no cluster question")  # noqa: E731
    for refractory in (2, 300, klif.MAX_REFRACTORY):
        assert klif.dense_plan(256, 128, n_pad, refractory, never, never).body == klif.BLOCK
    assert klif.dense_plan(16, 128, n_pad, 2, never, never, body=klif.BLOCK).body == klif.BLOCK
    for body in (klif.CLUSTER, klif.ONE_THREAD):
        with pytest.raises(ValueError, match="only on the block body"):
            klif.dense_plan(16, 128, n_pad, 2, never, never, body=body)


@pytest.mark.parametrize("n_pad,refractory,match", [
    (10304, 2, "N_pad % 128"),           # the block body's 128-neuron blocks
    (5056, 2, "N_pad % 128"),
    (10240, 65536, "refractory"),        # past its 16-bit counter
    (10250, 2, "N_pad % 32"),
])
def test_dense_plan_still_refuses_what_the_block_body_cannot_run(n_pad, refractory, match):
    never = lambda *a: 0  # noqa: E731
    with pytest.raises(ValueError, match=match):
        klif.dense_plan(16, 128, n_pad, refractory, never, never)


def test_block_memory_gate(monkeypatch):
    """The block body's one size limit is its scratch allocation: where the
    allocator runs out, its OutOfMemoryError says what the scratch holds.
    At 10240 neurons the K-major blocks alone are 80 x 81 x 32 KB."""
    blocks = 80 * 81 * 128 * 128 * 2
    sc = klif.alloc_block_scratch(1000, CPU, 10240, 80)
    assert sc.dtype == torch.uint8 and sc.numel() == 1000

    def out_of_memory(*a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(torch, "empty", out_of_memory)
    with pytest.raises(torch.OutOfMemoryError,
                       match="10240 neurons and 80 source blocks.*212.3 MB.*out of memory"):
        klif.alloc_block_scratch(blocks, CPU, 10240, 80)
