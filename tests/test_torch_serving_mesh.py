"""The port's serving engines over several ranks (the mesh paths of
lsm_tpu_torch/models/{streaming,continuous,pool}.py and io/serving_state.py)
against the port's single-process engines and lsm_tpu's mesh engines.

The port runs one process per device: one module-scope spawn of 2 gloo
ranks on the CPU (a 2x1 mesh), each with one torch thread, joined through
the LSM_TPU_COORDINATOR env contract, as tests/test_torch_parallel.py
does. lsm_tpu's mesh engines run in this process on 2 of its 8 virtual CPU
devices (tests/conftest.py), with the same weights through `convert`. One
script (SCENARIOS) drives all three: 8 streams, 100 ms hops, 16 filters,
128 neurons (dense, block-sparse, and dense behind the mel frontend),
dyadic weights with zero leak (equal spikes in give equal statistics out).
It is the port's counterpart of tests/test_continuous.py:718, :738, :777,
tests/test_streaming.py:132, :163, :209, tests/test_step_active.py:79,
tests/test_serving_diagnostics.py:110 and tests/test_serving_state.py:95,
:133, :445, :604, plus the pool and fit_continuous_readout over the mesh.

Tolerances:
  - mesh against the single process: the state leaves, features,
    snapshots, extracted rows, diagnostics and fitted readout bit-equal;
    logits, margins and the fused checksum within 1e-5 relative with the
    argmax equal (on the CPU they come out bit-equal, which the test
    reports);
  - mesh against lsm_tpu's mesh: tests/test_torch_continuous.py's and
    tests/test_torch_streaming.py's: logits rtol 1e-4 / atol 1e-5 (of the
    row's largest logit, at least 1: the random readout's logits of
    ~1e2-1e3 cancel to near 0 in places) with the argmax equal where the reference's top-1/top-2 margin exceeds
    1e-3, margins rtol 2e-3 / atol 1e-4, the spike-driven state leaves
    (membrane, refractory, last spikes, triggers, both rings) bit-equal,
    the frontend's float state (cascade, tail, peak/floor) rtol 1e-4 /
    atol 1e-5, features rtol 1e-5 / atol 1e-6 (the two variance features,
    whose subtraction lsm_tpu's epilogue may contract into an FMA, atol
    1e-4), the fitted scaler as tests/test_torch_continuous.py holds it.
    The exact engine's featurizer may flip a spike at a near-threshold
    value against lsm_tpu (tests/test_torch_ops.py), so its logits are
    held on the streams whose window spikes are equal.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lsm_tpu import config as jcfg
from lsm_tpu.io import dataset
from lsm_tpu.io import serving_state as jstate
from lsm_tpu.io.wav import to_pcm16_wire
from lsm_tpu.models import continuous as jcont
from lsm_tpu.models import frontend as jfront
from lsm_tpu.models import pool as jpool
from lsm_tpu.models import reservoir as jres
from lsm_tpu.models import sparse as jsp
from lsm_tpu.models import streaming as jstr
from lsm_tpu.ops import ulaw as julaw
from lsm_tpu.parallel import mesh as jmesh
from lsm_tpu.readout import logistic as jlog
from lsm_tpu.readout import scaler as jsc

from lsm_tpu_torch import config as tcfg
from lsm_tpu_torch.models import frontend as tfront

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N, L, K = 8, 1600, 4
KEYS = tuple(jcfg.FEATURE_SETS["original"])
VAR_KEYS = ("spike_variances", "isi_variances")

# The serving script both packages run. `api` hides the package and the
# placement: make(kind, model, n_streams, sharded) builds an engine, local()
# gives the rows of a full chunk the engine takes, save / load / migrate /
# Pool / fit are the package's, private and shared are directories (a file
# a single-device engine writes on every rank goes to private).
SCENARIOS = textwrap.dedent(
    '''
    import numpy as np

    L = 1600
    ACT = np.array([0, 5, 6])


    def _hop(a, h):
        return np.ascontiguousarray(a[:, h * L:(h + 1) * L])


    def _report(out, key, rep):
        out[key + ":diag"] = np.stack([np.asarray(rep.participation, np.float64),
                                       np.asarray(rep.spikes_per_neuron, np.float64)])


    def _leaves(out, key, leaves):
        for k, v in leaves.items():
            out[f"{key}:{k}"] = np.asarray(v)


    def run(api, inp):
        out = {}
        f32, i16, ulaw = inp["audio_f32"], inp["audio_i16"], inp["audio_ulaw"]

        def step(kws, x):
            return kws.step(api.local(kws, x))

        # The continuous engine (tests/test_continuous.py:718, :738, :777,
        # tests/test_step_active.py:79, tests/test_serving_diagnostics.py:110).
        cm = api.make("continuous", "dense", 8, True)
        for h, a in enumerate((f32, i16, ulaw)):
            out[f"cont:h{h}:logits"] = step(cm, _hop(a, h))
        out["cont:compact:preds"], out["cont:compact:margin"] = cm.step_compact(
            api.local(cm, _hop(i16, 3)))
        out["cont:active:logits"] = cm.step_active(_hop(f32, 4)[ACT], ACT)
        cm.reset([0, 5])                      # slots on both ranks
        out["cont:reset:logits"] = step(cm, _hop(f32, 5))
        mask = np.zeros(8, bool)
        mask[[1, 6]] = True
        cm.reset(mask)
        out["cont:mask:logits"] = step(cm, _hop(f32, 6))
        out["cont:fused:sum"] = np.asarray(cm.steps_fused(api.local(cm, _hop(f32, 7)), 2))
        out["cont:stream:logits"] = np.stack(list(cm.stream(
            [api.local(cm, _hop(f32, h)) for h in (8, 9)])))
        out["cont:feats"] = np.asarray(cm.features())
        _report(out, "cont:all", cm.diagnostics())
        _report(out, "cont:some", cm.diagnostics([1, 2, 6]))
        _leaves(out, "cont:snap", cm.snapshot())
        _leaves(out, "cont:rows", cm.extract_streams([6, 1]))

        # The state file across placements (tests/test_serving_state.py:95):
        # the mesh engine saved (rank 0 writes), one process loads it and
        # serves on; that one saved, a mesh engine loads it and serves on.
        api.save(api.shared / "cont.npz", cm)
        one = api.make("continuous", "dense", 8, False)
        api.load(api.shared / "cont.npz", one)
        out["file:one:logits"] = one.step(_hop(f32, 10))
        api.save(api.private / "one.npz", one)
        back = api.make("continuous", "dense", 8, True)
        api.load(api.private / "one.npz", back)
        out["file:mesh:logits"] = step(back, _hop(f32, 11))
        _leaves(out, "file:snap", back.snapshot())

        # Migration both ways (tests/test_serving_state.py:445).
        two = api.make("continuous", "dense", 2, False)
        api.migrate(back, two, [5, 6], [0, 1])
        out["migrate:one:logits"] = two.step(_hop(f32, 0)[[5, 6]])
        api.migrate(two, back, [0], [3])
        out["migrate:mesh:logits"] = step(back, _hop(f32, 1))
        _leaves(out, "migrate:snap", back.snapshot())

        # A hot readout swap on the mesh (tests/test_serving_state.py:604).
        cm.swap_readout(api.readout2)
        out["swap:logits"] = step(cm, _hop(f32, 10))

        # The exact engine (tests/test_streaming.py:132, :209; the state
        # file of tests/test_serving_state.py:133). Every hop records its
        # window for the reference comparison.
        em = api.make("exact", "dense", 8, True)

        def window(key, kws):
            out[f"exact:{key}:snap:buffer"] = kws.snapshot()["buffer"]

        for h, a in enumerate((f32, i16, ulaw)):
            out[f"exact:h{h}:logits"] = step(em, _hop(a, h))
            window(f"h{h}", em)
        em.push(api.local(em, _hop(f32, 3)))
        out["exact:h3:logits"] = em.logits()
        window("h3", em)
        em.reset(3)
        out["exact:h4:logits"] = step(em, _hop(f32, 4))
        window("h4", em)
        out["exact:h5:preds"], out["exact:h5:margin"] = em.step_compact(
            api.local(em, _hop(f32, 5)))
        window("h5", em)
        out["exact:h6:logits"] = em.step_active(_hop(i16, 6)[ACT], ACT)
        window("h6", em)
        _report(out, "exact:all", em.diagnostics())
        _leaves(out, "exact:rows", em.extract_streams([7, 2]))
        api.save(api.shared / "exact.npz", em)
        ex1 = api.make("exact", "dense", 8, False)
        api.load(api.shared / "exact.npz", ex1)
        out["exact:h7:logits"] = ex1.step(_hop(f32, 7))
        window("h7", ex1)

        # The block-sparse reservoir and the mel frontend (its iir leaf is
        # zero-size) on the continuous engine.
        for name in ("sparse", "mel"):
            e = api.make("continuous", name, 8, True)
            for h in range(3):
                out[f"{name}:h{h}:logits"] = step(e, _hop(i16, h))
            _leaves(out, f"{name}:snap", e.snapshot())
            _leaves(out, f"{name}:rows", e.extract_streams([2, 7]))

        # fit_continuous_readout over the mesh.
        out["fit:scaler_mean"], out["fit:scaler_scale"], out["fit:ro_w"], out["fit:ro_b"] = \\
            api.fit("dense", inp["fit_audio"], inp["fit_labels"])

        # The pool over the mesh: admit, step on global rows, finish,
        # diagnostics, save (rank 0), restore, drain to one process.
        pm = api.Pool(api.make("continuous", "dense", 8, True))
        sess = ["a", "b", "c"]
        for s in sess:
            pm.admit(s)
        decided = []
        for h in range(3):
            fed = {s: _hop(f32, h)[i] for i, s in enumerate(sess) if (h, s) != (1, "b")}
            decided.append(pm.step(fed))
        pm.finish("a")
        pm.admit("d")
        decided.append(pm.step({"c": _hop(f32, 3)[2], "d": _hop(f32, 3)[3]}))
        rep, _ = pm.diagnostics()
        _report(out, "pool", rep)
        pm.save(api.shared / "pool.npz")
        pr = api.Pool.restore(api.shared / "pool.npz", api.make("continuous", "dense", 8, True))
        decided.append(pr.step({"b": _hop(f32, 4)[1], "d": _hop(f32, 4)[3]}))
        dst = api.Pool(api.make("continuous", "dense", 4, False))
        pr.drain(["c"], dst)
        decided.append(dst.step({"c": _hop(f32, 5)[2]}))
        decided.append(pr.step({"d": _hop(f32, 5)[3]}))
        pairs = [d[s] for d in decided for s in sorted(d)]
        out["pool:preds"] = np.asarray([p for p, _ in pairs], np.int32)
        out["pool:margin"] = np.asarray([m for _, m in pairs], np.float32)

        # A stream count that does not divide over the data axis
        # (tests/test_streaming.py:163).
        try:
            api.make("exact", "dense", 7, True)
            out["indivisible:msg"] = np.asarray("")
        except ValueError as e:
            out["indivisible:msg"] = np.asarray(str(e))
        return out
    '''
)

WORKER = textwrap.dedent(
    """
    import sys
    from pathlib import Path
    from types import SimpleNamespace

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from lsm_tpu_torch.parallel import mesh as ml

    assert ml.maybe_init_distributed_from_env(), "env contract not honored"
    import torch.distributed as dist

    from scenarios import run
    from port_api import port_api

    rank = dist.get_rank()
    inp = dict(np.load(sys.argv[2]))
    mesh = ml.make_mesh(2, 1)
    shared = Path(sys.argv[1]).parent / "shared"
    private = Path(sys.argv[1]).parent / f"private{rank}"
    private.mkdir(exist_ok=True)
    out = run(port_api(inp, mesh, private, shared), inp)
    # A 1x2 mesh: both ranks of the one data coordinate serve every row.
    m12 = ml.make_mesh(1, 2)
    e = port_api(inp, m12, private, shared).make("continuous", "dense", 8, True)
    for h, a in enumerate((inp["audio_f32"], inp["audio_i16"], inp["audio_ulaw"])):
        out[f"model2:h{h}:logits"] = e.step(a[e.rows, h * 1600:(h + 1) * 1600])
    np.savez(f"{sys.argv[1]}.rank{rank}.npz", **out)
    ml.barrier(mesh)
    print(f"rank {rank} done", flush=True)
    """
)

# The port side of `api`: shared by the ranks and the single-process run.
PORT_API = textwrap.dedent(
    """
    from types import SimpleNamespace

    import numpy as np

    from lsm_tpu_torch import config as tcfg
    from lsm_tpu_torch import convert
    from lsm_tpu_torch.io import serving_state
    from lsm_tpu_torch.models.continuous import ContinuousKWS, fit_continuous_readout
    from lsm_tpu_torch.models.pool import StreamPool
    from lsm_tpu_torch.models.streaming import StreamingKWS


    def _params(inp, prefix):
        return SimpleNamespace(**{k[len(prefix) + 2:]: (v if v.ndim else v.item())
                                  for k, v in inp.items() if k.startswith(prefix + "__")})


    def port_api(inp, mesh, private, shared):
        dense = convert.reservoir(_params(inp, "dense"))
        sparse = convert.sparse_reservoir(_params(inp, "sparse"))
        ro, sc = convert.readout(_params(inp, "ro")), convert.scaler(_params(inp, "sc"))
        gt = tcfg.FrontendConfig(n_filters=16)
        models = {"dense": (dense, gt), "sparse": (sparse, gt),
                  "mel": (dense, tcfg.FrontendConfig(filterbank="mel", n_filters=16))}

        def make(kind, model, n, sharded):
            res, fcfg = models[model]
            cls = StreamingKWS if kind == "exact" else ContinuousKWS
            return cls(res, ro, sc, fcfg, "original", n, mesh=mesh if sharded else None)

        def fit(model, audio, labels):
            r, s = fit_continuous_readout(models[model][0], models[model][1], audio, labels,
                                          int(labels.max()) + 1, mesh=mesh, max_iter=60)
            return (s.mean.numpy(), s.scale.numpy(), r.w.numpy(), r.b.numpy())

        return SimpleNamespace(
            make=make, local=lambda kws, x: x[kws.rows], save=serving_state.save_serving_state,
            load=serving_state.load_serving_state, migrate=serving_state.migrate_streams,
            Pool=StreamPool, fit=fit, readout2=convert.readout(_params(inp, "ro2")),
            private=private, shared=shared)
    """
)


def _scenarios():
    ns = {}
    exec(SCENARIOS, ns)
    return ns["run"]


def _port_api(*args):
    ns = {}
    exec(PORT_API, ns)
    return ns["port_api"](*args)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dyadic(params, name):
    q = lambda a: jnp.round(jnp.asarray(a) * 256.0) / 256.0       # noqa: E731
    return dataclasses.replace(params, **{name: q(getattr(params, name))},
                               w_in=q(params.w_in), leak=jnp.zeros_like(params.leak))


def _flat(prefix, params):
    if dataclasses.is_dataclass(params):
        fields = [f.name for f in dataclasses.fields(params)]
    else:
        fields = list(params._fields)
    return {f"{prefix}__{f}": np.asarray(getattr(params, f)) for f in fields}


def _readout(seed):
    d = len(KEYS) * 64
    rng = np.random.default_rng(seed)
    ro = jlog.LogisticParams(w=jnp.asarray(rng.normal(0, 0.1, (d, K)).astype(np.float32)),
                             b=jnp.asarray(rng.normal(0, 0.1, K).astype(np.float32)))
    sc = jsc.ScalerState(mean=jnp.asarray(rng.random(d).astype(np.float32)),
                         scale=jnp.asarray((rng.random(d) + 0.5).astype(np.float32)))
    return ro, sc


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """lsm_tpu's weights (dyadic, zero leak) and the audio, as host arrays."""
    rc = jcfg.ReservoirConfig(num_neurons=128, num_output_neurons=64, small_world_k=16,
                              mean_weight=0.03, input_fanout=6)
    dense = _dyadic(jres.init_reservoir(rc, n_channels=16), "w_rec")
    sparse = _dyadic(jsp.init_reservoir_sparse(
        dataclasses.replace(rc, small_world_k=26, sparse=True), n_channels=16), "w_blocks")
    ro, sc = _readout(5)
    ro2, _ = _readout(6)
    a, _ = dataset.synthetic_audio_batch_hard(2, N, seed=3)
    audio = a.reshape(N, -1)[:, :12 * L]
    fit_audio, fit_labels = dataset.synthetic_audio_batch_hard(2, K, seed=11)
    arrays = {**_flat("dense", dense), **_flat("sparse", sparse), **_flat("ro", ro),
              **_flat("sc", sc), **_flat("ro2", ro2),
              "audio_f32": audio.astype(np.float32), "audio_i16": to_pcm16_wire(audio),
              "audio_ulaw": julaw.encode_ulaw_f32(audio),
              "fit_audio": fit_audio, "fit_labels": fit_labels.astype(np.int32)}
    d = tmp_path_factory.mktemp("serving_mesh_inputs")
    np.savez(d / "inputs.npz", **arrays)
    models = {"dense": (dense, jcfg.FrontendConfig(n_filters=16)),
              "sparse": (sparse, jcfg.FrontendConfig(n_filters=16)),
              "mel": (dense, jcfg.FrontendConfig(filterbank="mel", n_filters=16))}
    return d / "inputs.npz", arrays, models, (ro, sc, ro2)


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Both ranks' results of the script on the port's 2x1 mesh."""
    path, _, _, _ = inputs
    d = tmp_path_factory.mktemp("serving_mesh_ranks")
    (d / "shared").mkdir()
    (d / "scenarios.py").write_text(SCENARIOS)
    (d / "port_api.py").write_text(PORT_API)
    (d / "worker.py").write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": f"{REPO}:{d}:{os.environ.get('PYTHONPATH', '')}",
           "LSM_TPU_COORDINATOR": f"localhost:{_free_port()}", "LSM_TPU_NUM_PROCESSES": "2",
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(d / "worker.py"), str(d / "out"), str(path)],
                              env={**env, "LSM_TPU_PROCESS_ID": str(i)}, cwd=d,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i} failed:\n{logs[i][-4000:]}"
    return [dict(np.load(d / f"out.rank{i}.npz")) for i in range(2)], d / "shared"


@pytest.fixture(scope="module")
def single(inputs, tmp_path_factory):
    """The script on the port's single-process engines."""
    _, arrays, _, _ = inputs
    d = tmp_path_factory.mktemp("serving_mesh_single")
    return _scenarios()(_port_api(arrays, None, d, d), arrays)


@pytest.fixture(scope="module")
def reference(inputs, tmp_path_factory):
    """The script on lsm_tpu's mesh engines (2 of the 8 CPU devices)."""
    _, arrays, models, (ro, sc, ro2) = inputs
    d = tmp_path_factory.mktemp("serving_mesh_reference")
    mesh = jmesh.make_mesh(n_data=2, n_model=1)
    REFERENCE_FILES.append(d)

    def make(kind, model, n, sharded):
        params, fcfg = models[model]
        cls = jstr.StreamingKWS if kind == "exact" else jcont.ContinuousKWS
        return cls(params, ro, sc, fcfg, "original", n, mesh=mesh if sharded else None)

    def fit(model, audio, labels):
        r, s = jcont.fit_continuous_readout(models[model][0], models[model][1], audio, labels,
                                            int(labels.max()) + 1, mesh=mesh, max_iter=60)
        return tuple(np.asarray(a) for a in (s.mean, s.scale, r.w, r.b))

    api = SimpleNamespace(make=make, local=lambda kws, x: x,
                          save=jstate.save_serving_state, load=jstate.load_serving_state,
                          migrate=jstate.migrate_streams, Pool=jpool.StreamPool, fit=fit,
                          readout2=ro2, private=d, shared=d)
    return _scenarios()(api, arrays)


REFERENCE_FILES = []
SCENARIO_NAMES = ("cont", "file", "migrate", "swap", "exact", "sparse", "mel", "fit", "pool")


def _keys(out, scenario):
    return sorted(k for k in out if k.split(":")[0] == scenario)


def test_every_rank_gets_every_result(ranks):
    """The outputs come back whole on both ranks: rank 1's equal rank 0's."""
    r0, r1 = ranks[0]
    assert sorted(r0) == sorted(r1)
    for k in r0:
        np.testing.assert_array_equal(r1[k], r0[k], err_msg=k)
    assert r0["cont:h0:logits"].shape == (N, K)
    assert r0["cont:snap:v"].shape[0] == N


def test_model_axis_serves_every_row(ranks, single):
    """On a 1x2 mesh each rank holds all 8 streams (the model axis
    replicates the engine, as lsm_tpu's shard_map does): the same logits
    as one process on both ranks."""
    for r in ranks[0]:
        for h in range(3):
            np.testing.assert_array_equal(r[f"model2:h{h}:logits"], single[f"cont:h{h}:logits"])


@pytest.mark.parametrize("scenario", SCENARIO_NAMES)
def test_mesh_equals_single_process(ranks, single, scenario):
    """State, features, snapshots, rows, diagnostics and fits bit-equal;
    logits and margins within 1e-5 relative with the argmax equal."""
    got = ranks[0][0]
    keys = _keys(single, scenario)
    assert keys and keys == _keys(got, scenario)
    inexact = []
    for k in keys:
        a, b = got[k], single[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k.endswith((":logits", ":margin", ":sum")):
            if not np.array_equal(a, b):
                inexact.append(k)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=k)
            if k.endswith(":logits"):
                np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1), err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    print(f"{scenario}: outputs not bit-equal to the single process: {inexact or 'none'}")


def _sure(ref):
    top2 = np.sort(ref, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] > 1e-3


def _logits_match(port, ref, k):
    # atol 1e-5 of the row's largest logit: the random readout sums 320
    # features of up to ~1e2 into logits of ~1e2-1e3, some near 0, so the
    # variance features' FMA difference (<= ~1e-6 relative) shows there.
    atol = 1e-5 * np.maximum(1.0, np.abs(ref).max(-1, keepdims=True))
    bad = np.abs(port - ref) > atol + 1e-4 * np.abs(ref)
    assert not bad.any(), (k, port[bad], ref[bad])
    sure = _sure(ref)
    np.testing.assert_array_equal(port.argmax(-1)[sure], ref.argmax(-1)[sure], err_msg=k)


_SPIKE_LEAVES = ("v", "refrac", "s_prev", "hyst", "win_ring", "buffer")
_FLOAT_LEAVES = ("iir", "tail", "norm_hi", "norm_lo")


def _leaf_match(port, ref, k):
    leaf = k.split(":snap:")[-1].split(":rows:")[-1]
    if leaf.startswith("seg:") or leaf in _SPIKE_LEAVES:
        np.testing.assert_array_equal(port, ref, err_msg=k)
    else:
        assert leaf in _FLOAT_LEAVES, k
        np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-5, err_msg=k)


def _features_match(port, ref, k):
    no = port.shape[1] // len(KEYS)
    for i, name in enumerate(KEYS):
        a, b = port[:, i * no:(i + 1) * no], ref[:, i * no:(i + 1) * no]
        atol = 1e-4 if name in VAR_KEYS else 1e-6
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol, err_msg=f"{k} {name}")


def _equal_window_rows(port_buffer, ref_buffer):
    """Streams whose window spikes are equal in both packages' featurizers
    (the buffers themselves must be bit-equal)."""
    np.testing.assert_array_equal(port_buffer, ref_buffer)
    fcfg = jcfg.FrontendConfig(n_filters=16)
    sj = np.asarray(jfront.featurize_batch(jnp.asarray(ref_buffer), fcfg))
    st = tfront.featurize_batch(torch.as_tensor(port_buffer),
                                tcfg.FrontendConfig(n_filters=16)).numpy()
    flips = st != sj
    assert flips.mean() <= 1e-3
    return ~flips.any(axis=(1, 2))


@pytest.mark.parametrize("scenario", SCENARIO_NAMES + ("indivisible",))
def test_mesh_equals_reference(ranks, reference, scenario):
    """The port's mesh engines against lsm_tpu's at the port's serving
    tolerances (module docstring)."""
    got = ranks[0][0]
    keys = _keys(reference, scenario)
    assert keys and keys == _keys(got, scenario)
    for k in keys:
        a, b = got[k], reference[k]
        if k.endswith(":msg"):
            assert str(a) == str(b) != "", k
        elif scenario == "exact" and k.endswith((":logits", ":preds", ":margin")):
            hop = k.split(":")[1]
            eq = _equal_window_rows(got[f"exact:{hop}:snap:buffer"],
                                    reference[f"exact:{hop}:snap:buffer"])
            assert eq.mean() >= 0.75, (k, eq)
            if k.endswith(":logits"):
                _logits_match(a[eq], b[eq], k)
            elif k.endswith(":margin"):
                np.testing.assert_allclose(a[eq], b[eq], rtol=2e-3, atol=1e-4, err_msg=k)
            else:
                sure = reference[f"exact:{hop}:margin"][eq] > 1e-3
                np.testing.assert_array_equal(a[eq][sure], b[eq][sure], err_msg=k)
        elif k.endswith(":logits"):
            _logits_match(a, b, k)
        elif k.endswith(":margin"):
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-4, err_msg=k)
        elif k.endswith(":preds"):
            sure = reference[k[:-len("preds")] + "margin"] > 1e-3
            np.testing.assert_array_equal(a[sure], b[sure], err_msg=k)
        elif k.endswith(":sum"):
            np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=k)
        elif k.endswith(":feats"):
            _features_match(a, b, k)
        elif k.endswith(":diag"):
            if scenario != "exact":         # the exact engine re-featurizes: flips
                np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=k)
        elif ":snap:" in k or ":rows:" in k:
            _leaf_match(a, b, k)
        elif k == "fit:scaler_mean":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=k)
        elif k == "fit:scaler_scale":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=k)
        elif k in ("fit:ro_w", "fit:ro_b"):
            # torch's and optax's L-BFGS stop at different iterates
            # (tests/test_torch_continuous.py judges the fits by objective
            # on one process); the scaler above holds the gathered
            # features, and the readout is held bit-equal to the port's
            # single-process fit.
            pass
        else:
            raise AssertionError(f"no rule for {k}")


def test_state_files_cross_with_lsm_tpu_mesh(inputs, ranks, reference):
    """The file the port's two ranks wrote (rank 0) loads into lsm_tpu's
    mesh engine, and the file lsm_tpu's mesh engine wrote loads into the
    port's engine (the weights through `convert` digest alike); both serve
    the next hop as the loading package's own engines did from their own
    file, at the reference tolerance."""
    from lsm_tpu_torch.io import serving_state as tstate

    _, arrays, models, (ro, sc, _) = inputs
    hop = np.ascontiguousarray(arrays["audio_f32"][:, 10 * L:11 * L])
    params, fcfg = models["dense"]
    j = jcont.ContinuousKWS(params, ro, sc, fcfg, "original", N,
                            mesh=jmesh.make_mesh(n_data=2, n_model=1))
    assert jstate.load_serving_state(ranks[1] / "cont.npz", j)["engine"] == "continuous"
    _logits_match(j.step(hop), reference["file:one:logits"], "port file -> lsm_tpu")
    t = _port_api(arrays, None, None, None).make("continuous", "dense", N, False)
    assert tstate.load_serving_state(REFERENCE_FILES[0] / "cont.npz", t)["n_streams"] == N
    _logits_match(t.step(hop), ranks[0][0]["file:one:logits"], "lsm_tpu file -> port")
