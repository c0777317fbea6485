"""The port's multi-device batch and training path (lsm_tpu_torch/parallel,
the mesh branches of the readout fits, the calibration and the pipeline)
against lsm_tpu's mesh functions.

The port runs one process per device: the test spawns gloo ranks on the CPU
as subprocesses, 2 (a 2x1 mesh) and 4 (2x2 and 1x4), each with one torch
thread, joined through the LSM_TPU_COORDINATOR env contract. lsm_tpu's
counterparts run in this process on its 8 virtual CPU devices
(tests/conftest.py) on the same NumPy inputs and weights (carried across
with `convert`). Tolerances:
  - extract_features_dp on dyadic weights: the raster-exact features
    bit-equal, the two variance features at rtol 1e-4 / atol 1e-5 (the
    reference's compiled programs may contract their epilogue into an FMA;
    tests/test_torch_sparse.py);
  - the tensor-parallel reservoirs, dense and block-sparse: rtol/atol 1e-4
    (tests/test_sharding.py:56-72);
  - fit_ridge_dp: rtol 1e-4 / atol 1e-5 (tests/test_readout_dp.py);
  - fit_logistic_dp: against the port's single-device fit (the same
    optimizer) at atol 5e-3 with equal predictions, lsm_tpu's rule for its
    DP fit against its single-device one (tests/test_readout_dp.py);
    against lsm_tpu's DP fit the weights W at atol 5e-3, equal
    predictions and the objective within 1e-4 of it. The intercepts are
    held by those two: the objective is flat along them (unpenalized, and
    scaled by 1/N), and torch's and optax's L-BFGS stop 0.026 apart in b at
    their common stopping rule (tests/test_torch_readout.py holds the
    single-device fits by objective for the same reason);
  - make_train_step: three steps' losses at rtol 1e-4;
  - a batch that does not divide over the data axis (padding;
    tests/test_mesh_pipeline.py:79): spikes bit-equal to the port's single
    device, the accuracy equal to it and to lsm_tpu's mesh path.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lsm_tpu import config as jcfg
from lsm_tpu import pipeline as jpipe
from lsm_tpu.io import artifacts as jart
from lsm_tpu.models import reservoir as jres
from lsm_tpu.models import sparse as jsp
from lsm_tpu.parallel import mesh as jmesh
from lsm_tpu.parallel import sharded as jsh
from lsm_tpu.parallel.train_step import ReadoutState as JReadoutState
from lsm_tpu.parallel.train_step import make_train_step as j_make_train_step
from lsm_tpu.readout import logistic as jlog

from lsm_tpu_torch import config as tcfg
from lsm_tpu_torch import pipeline as tpipe
from lsm_tpu_torch.io import artifacts as tart

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
KEYS = tuple(jcfg.FEATURE_SETS["original"])
EXACT = (0, 2, 3)                  # spike_counts, mean_spike_times, mean_isi
NO = 64
CPU = torch.device("cpu")
MESHES = {2: [(2, 1)], 4: [(2, 2), (1, 4)]}

WORKER = textwrap.dedent(
    """
    import json, sys
    from types import SimpleNamespace

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from lsm_tpu_torch.parallel import mesh as ml

    assert ml.maybe_init_distributed_from_env(), "env contract not honored"
    import torch.distributed as dist

    from lsm_tpu_torch import config as tcfg
    from lsm_tpu_torch import convert
    from lsm_tpu_torch import pipeline as tpipe
    from lsm_tpu_torch.io import artifacts as tart
    from lsm_tpu_torch.models.calibration import calibrate_weight
    from lsm_tpu_torch.parallel import sharded
    from lsm_tpu_torch.parallel.train_step import ReadoutState, make_train_step
    from lsm_tpu_torch.readout import logistic

    inp = dict(np.load(sys.argv[2]))
    shapes = json.loads(sys.argv[3])
    keys = tuple(tcfg.FEATURE_SETS["original"])
    cpu = torch.device("cpu")

    def params(prefix):
        return SimpleNamespace(**{k[len(prefix) + 2:]: (v if v.ndim else v.item())
                                  for k, v in inp.items() if k.startswith(prefix + "__")})

    dense = convert.reservoir(params("dense"))
    dyadic = convert.reservoir(params("dyadic"))
    sparse = convert.sparse_reservoir(params("sparse"))
    x, x_train = inp["spikes"], inp["train_spikes"]
    out = {}
    for n_data, n_model in shapes:
        mesh = ml.make_mesh(n_data, n_model)
        tag = f"{n_data}x{n_model}"
        gather = lambda t: ml.host_local(t, mesh).numpy()
        out["dp_" + tag] = gather(sharded.extract_features_dp(
            dyadic, ml.shard_batch(x, mesh), keys, mesh))
        out["tp_" + tag] = gather(sharded.extract_features_model_sharded(
            dense, ml.shard_batch(x, mesh), keys, mesh))
        if sparse.w_blocks.shape[0] % n_model == 0:
            out["tps_" + tag] = gather(sharded.extract_features_model_sharded_sparse(
                sparse, ml.shard_batch(x, mesh), keys, mesh))
        step = make_train_step(dense, keys, num_classes=3, mesh=mesh, lr=0.5)
        state = ReadoutState(torch.zeros(len(keys) * dense.n_outputs, 3), torch.zeros(3))
        losses = []
        for _ in range(3):
            loss, state = step(ml.shard_batch(x_train, mesh),
                               ml.shard_batch(inp["train_labels"], mesh), state)
            losses.append(float(loss))
        out["losses_" + tag] = np.asarray(losses)
        out["train_w_" + tag], out["train_b_" + tag] = convert.readout_state_arrays(state)

    if [2, 1] in shapes:
        mesh = ml.auto_mesh()
        assert mesh.shape == {"data": 2, "model": 1}
        ridge = logistic.fit_ridge_dp(inp["toy_x"], inp["toy_y"], 5, mesh)
        out["ridge_w"], out["ridge_b"] = ridge.w.numpy(), ridge.b.numpy()
        lg, it = logistic.fit_logistic_dp(inp["toy_x"], inp["toy_y"], 5, mesh, max_iter=200)
        out["logistic_w"], out["logistic_b"] = lg.w.numpy(), lg.b.numpy()
        cfg = tcfg.ReservoirConfig()
        out["w_critico"] = np.asarray(calibrate_weight(cfg, inp["calib"], 0.6, mesh=mesh))
        pcfg = tcfg.PipelineConfig(frontend=tcfg.FrontendConfig(n_filters=16), batch_size=3)
        out["odd_spikes"] = tpipe.featurize_audio_array(pcfg, inp["odd_audio"], cpu)
        art = tart.FeatureArtifact(inp["art_x_train"], inp["art_y_train"],
                                   inp["art_x_test"], inp["art_y_test"], "original", None)
        res = tpipe.train_and_evaluate(
            tcfg.PipelineConfig(commands=("a", "b", "c", "d", "e")), art, cpu)
        out["odd_accuracy"] = np.asarray(res.accuracy)
        out["odd_readout_w"] = res.readout.w.numpy()
    if dist.get_rank() == 0:
        np.savez(sys.argv[1], **out)
    print(f"rank {dist.get_rank()} done", flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spikes(seed, b, c=32, t=40, p=0.15):
    return (np.random.default_rng(seed).random((b, c, t)) < p).astype(np.uint8)


def _toy_problem(n=257, d=24, k=5, seed=0):
    """tests/test_readout_dp.py's problem: n deliberately not divisible by
    2 or 4."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 2.0, (k, d)).astype(np.float32)
    y = rng.integers(0, k, n).astype(np.int32)
    x = centers[y] + rng.normal(0, 1.0, (n, d)).astype(np.float32)
    return x.astype(np.float32), y


def _dense(quantize=False):
    cfg = jcfg.ReservoirConfig(num_neurons=256, num_output_neurons=NO, small_world_k=32,
                               mean_weight=0.02, input_fanout=6, seed=0)
    p = jres.init_reservoir(cfg, n_channels=32)
    if quantize:
        q = lambda a: jnp.round(jnp.asarray(a) * 256.0) / 256.0       # noqa: E731
        p = dataclasses.replace(p, w_rec=q(p.w_rec), w_in=q(p.w_in),
                                leak=jnp.zeros_like(p.leak))
    return p


def _sparse():
    cfg = jcfg.ReservoirConfig(num_neurons=256, num_output_neurons=NO, small_world_k=52,
                               mean_weight=0.02, input_fanout=6, sparse_partner_blocks=1,
                               seed=9)
    return jsp.init_reservoir_sparse(cfg, n_channels=32)


def _flat(prefix, params):
    return {f"{prefix}__{f.name}": np.asarray(getattr(params, f.name))
            for f in dataclasses.fields(params)}


def _train_data():
    x = _spikes(11, 24)
    density = x.mean(axis=(1, 2))
    labels = np.digitize(density, np.quantile(density, [1 / 3, 2 / 3])).astype(np.int32)
    return x, labels


def _odd_artifact():
    """Standardized features of the toy problem with a test split of 27 rows
    (not divisible by 2)."""
    x, y = _toy_problem(n=107, seed=3)
    x = (x - x.mean(0)) / x.std(0)
    return x[:80], y[:80], x[80:], y[80:]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    x_train, y_train = _train_data()
    toy_x, toy_y = _toy_problem()
    art = _odd_artifact()
    arrays = {
        **_flat("dense", _dense()), **_flat("dyadic", _dense(quantize=True)),
        **_flat("sparse", _sparse()),
        "spikes": _spikes(0, 12), "train_spikes": x_train, "train_labels": y_train,
        "toy_x": toy_x, "toy_y": toy_y, "calib": _spikes(5, 13, p=0.07),
        "odd_audio": (np.random.default_rng(4).standard_normal((5, 16000)) * 0.2
                      ).astype(np.float32),
        "art_x_train": art[0], "art_y_train": art[1], "art_x_test": art[2],
        "art_y_test": art[3],
    }
    path = d / "inputs.npz"
    np.savez(path, **arrays)
    return path, arrays


def _run_ranks(world, inputs_path, out_dir):
    port = _free_port()
    script = out_dir / "worker.py"
    script.write_text(WORKER)
    out = out_dir / f"world{world}.npz"
    env = {**os.environ, "PYTHONPATH": f"{REPO}:{os.environ.get('PYTHONPATH', '')}",
           "LSM_TPU_COORDINATOR": f"localhost:{port}", "LSM_TPU_NUM_PROCESSES": str(world),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(script), str(out), str(inputs_path),
                               json.dumps(MESHES[world])],
                              env={**env, "LSM_TPU_PROCESS_ID": str(i)}, cwd=out_dir,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(world)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i} of {world} failed:\n{logs[i][-4000:]}"
    return dict(np.load(out))


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Both launches, started together: {world: rank 0's results}."""
    from concurrent.futures import ThreadPoolExecutor

    path, _ = inputs
    d = tmp_path_factory.mktemp("ranks")
    with ThreadPoolExecutor(2) as pool:
        futs = {w: pool.submit(_run_ranks, w, path, d / f"w{w}") for w in MESHES
                if (d / f"w{w}").mkdir() is None}
        return {w: f.result() for w, f in futs.items()}


CASES = [(w, s) for w, shapes in MESHES.items() for s in shapes]


def _mesh(shape):
    return jmesh.make_mesh(n_data=shape[0], n_model=shape[1])


def _assert_features(port, ref):
    for i in EXACT:
        np.testing.assert_array_equal(port[:, i * NO:(i + 1) * NO], ref[:, i * NO:(i + 1) * NO],
                                      err_msg=KEYS[i])
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world,shape", CASES)
def test_extract_features_dp_equals_reference(ranks, inputs, world, shape):
    x = inputs[1]["spikes"]
    ref = np.asarray(jsh.extract_features_dp(_dense(quantize=True), jnp.asarray(x), KEYS,
                                             _mesh(shape)))
    port = ranks[world][f"dp_{shape[0]}x{shape[1]}"]
    assert port.shape == ref.shape == (12, len(KEYS) * NO)
    _assert_features(port, ref)
    assert port[:, :NO].sum() > 0


@pytest.mark.parametrize("world,shape", CASES)
def test_tensor_parallel_dense_equals_reference(ranks, inputs, world, shape):
    x = inputs[1]["spikes"]
    ref = np.asarray(jsh.extract_features_model_sharded(_dense(), jnp.asarray(x), KEYS,
                                                        _mesh(shape)))
    port = ranks[world][f"tp_{shape[0]}x{shape[1]}"]
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-4)
    assert port[:, :NO].sum() > 0


@pytest.mark.parametrize("world,shape", [c for c in CASES if 2 % c[1][1] == 0])
def test_tensor_parallel_sparse_equals_reference(ranks, inputs, world, shape):
    x = inputs[1]["spikes"]
    ref = np.asarray(jsh.extract_features_model_sharded_sparse(_sparse(), jnp.asarray(x),
                                                               KEYS, _mesh(shape)))
    port = ranks[world][f"tps_{shape[0]}x{shape[1]}"]
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-4)
    assert port[:, :NO].sum() > 0


@pytest.mark.parametrize("world,shape", CASES)
def test_train_step_losses_equal_reference(ranks, world, shape):
    x, labels = _train_data()
    params = _dense()
    step = j_make_train_step(params, KEYS, num_classes=3, mesh=_mesh(shape), lr=0.5)
    d = len(KEYS) * NO
    state = JReadoutState(w=jnp.zeros((d, 3), jnp.float32), b=jnp.zeros((3,), jnp.float32))
    losses = []
    for _ in range(3):
        loss, state = step(jnp.asarray(x), jnp.asarray(labels), state)
        losses.append(float(loss))
    tag = f"{shape[0]}x{shape[1]}"
    np.testing.assert_allclose(ranks[world]["losses_" + tag], losses, rtol=1e-4)
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(ranks[world]["train_b_" + tag], np.asarray(state.b),
                               rtol=1e-3, atol=1e-5)


def test_fit_ridge_dp_equals_reference(ranks):
    x, y = _toy_problem()
    ref = jlog.fit_ridge_dp(x, y, num_classes=5, mesh=_mesh((2, 1)))
    np.testing.assert_allclose(ranks[2]["ridge_w"], np.asarray(ref.w), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ranks[2]["ridge_b"], np.asarray(ref.b), rtol=1e-4, atol=1e-5)


def _objective64(w, b, x, y):
    z = x.astype(np.float64) @ np.asarray(w, np.float64) + np.asarray(b, np.float64)
    z -= z.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    return -logp[np.arange(len(y)), y].mean() + 0.5 * np.sum(np.asarray(w, np.float64) ** 2) / len(y)


def test_fit_logistic_dp_equals_single_device(ranks):
    from lsm_tpu_torch.readout import logistic as tlog

    x, y = _toy_problem()
    single, _ = tlog.fit_logistic(torch.as_tensor(x), torch.as_tensor(y), 5, max_iter=200)
    w, b = ranks[2]["logistic_w"], ranks[2]["logistic_b"]
    np.testing.assert_allclose(w, single.w.numpy(), rtol=0, atol=5e-3)
    np.testing.assert_allclose(b, single.b.numpy(), rtol=0, atol=5e-3)
    np.testing.assert_array_equal(np.argmax(x @ w + b, axis=1),
                                  tlog.predict(single, torch.as_tensor(x)).numpy())


def test_fit_logistic_dp_equals_reference(ranks):
    x, y = _toy_problem()
    ref, _ = jlog.fit_logistic_dp(x, y, num_classes=5, mesh=_mesh((2, 1)), max_iter=200)
    w, b = ranks[2]["logistic_w"], ranks[2]["logistic_b"]
    np.testing.assert_allclose(w, np.asarray(ref.w), rtol=0, atol=5e-3)
    pred = np.argmax(x @ w + b, axis=1)
    np.testing.assert_array_equal(pred, np.asarray(jlog.predict(ref, jnp.asarray(x))))
    f_ref = _objective64(ref.w, ref.b, x, y)
    assert abs(_objective64(w, b, x, y) - f_ref) <= 1e-4 * f_ref


def test_calibration_counts_are_exact(ranks, inputs):
    from lsm_tpu.models.calibration import calibrate_weight as j_calibrate
    from lsm_tpu_torch.models.calibration import calibrate_weight

    calib = inputs[1]["calib"]                        # 13 rows: uneven over 2 ranks
    single = calibrate_weight(tcfg.ReservoirConfig(), calib, 0.6)
    assert tuple(ranks[2]["w_critico"]) == single
    ref = j_calibrate(jcfg.ReservoirConfig(), jnp.asarray(calib), 0.6)
    np.testing.assert_allclose(single, ref, rtol=1e-6)


def test_padded_batches_equal_the_single_device(ranks, inputs):
    """5 utterances in batches of 3 (4 on the 2-rank mesh) do not divide
    over the data axis: the padded rows drop out."""
    cfg = tcfg.PipelineConfig(frontend=tcfg.FrontendConfig(n_filters=16), batch_size=3)
    single = tpipe.featurize_audio_array(cfg, inputs[1]["odd_audio"], CPU, mesh=None)
    assert single.shape == (5, 16, 400)
    np.testing.assert_array_equal(ranks[2]["odd_spikes"], single)


def test_padded_test_split_scores_as_the_single_device(ranks):
    x_tr, y_tr, x_te, y_te = _odd_artifact()
    cfg = tcfg.PipelineConfig(commands=("a", "b", "c", "d", "e"))
    art = tart.FeatureArtifact(x_tr, y_tr, x_te, y_te, "original", None)
    single = tpipe.train_and_evaluate(cfg, art, CPU, mesh=None)
    assert float(ranks[2]["odd_accuracy"]) == pytest.approx(single.accuracy, abs=1e-9)
    np.testing.assert_allclose(ranks[2]["odd_readout_w"], single.readout.w.numpy(), atol=5e-3)
    jart_ = jart.FeatureArtifact(x_tr, y_tr, x_te, y_te, "original", None)
    ref = jpipe.train_and_evaluate(jcfg.PipelineConfig(commands=cfg.commands), jart_,
                                   mesh=_mesh((2, 1)))
    assert single.accuracy == pytest.approx(ref.accuracy, abs=1e-9)
