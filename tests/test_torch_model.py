"""The model bundle (lsm_model.npz) across the two packages on the CPU: a
dense v1, a block-sparse v2-sparse and a continuous bundle written by
either package load in the other with every member equal (array, dtype,
shape) and the same JSON meta; the port builds the modules on the device
it is given and refuses what lsm_tpu refuses."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsm_tpu import config as jcfg
from lsm_tpu.io import model as jmodel
from lsm_tpu.models import reservoir as jres
from lsm_tpu.models import sparse as jsparse
from lsm_tpu.readout import logistic as jlog
from lsm_tpu.readout import scaler as jscaler

from lsm_tpu_torch import config as tcfg
from lsm_tpu_torch import convert
from lsm_tpu_torch.io import model as tmodel
from lsm_tpu_torch.models.reservoir import Reservoir
from lsm_tpu_torch.models.sparse import SparseReservoir

torch.set_num_threads(1)

CLASSES = ("a", "b", "c", "d")
CONT = {"chunk_len": 1600, "norm_decay_db_per_bin": 0.1}


def _reference_params(kind):
    """lsm_tpu reservoir, readout and scaler at a small width; `kind` is
    dense, sparse or continuous (a dense reservoir, continuous features)."""
    rng = np.random.default_rng(0)
    if kind == "sparse":
        rcfg = jcfg.ReservoirConfig(num_neurons=256, num_output_neurons=128, small_world_k=52,
                                    mean_weight=0.01, sparse=True)
        params = jsparse.init_reservoir_sparse(rcfg, n_channels=32)
    else:
        rcfg = jcfg.ReservoirConfig(num_neurons=192, num_output_neurons=96, small_world_k=38,
                                    mean_weight=0.02, input_fanout=6, leak_variance_divisor=4.0)
        params = jres.init_reservoir(rcfg, n_channels=32)
    d = 5 * params.n_outputs
    readout = jlog.LogisticParams(w=jnp.asarray(rng.standard_normal((d, 4)), jnp.float32),
                                  b=jnp.asarray(rng.standard_normal(4), jnp.float32))
    st = jscaler.ScalerState(mean=jnp.asarray(rng.standard_normal(d), jnp.float32),
                             scale=jnp.asarray(rng.random(d) + 0.5, jnp.float32))
    return params, readout, st


def _save_kwargs(kind):
    return dict(feature_mode="continuous" if kind == "continuous" else "batch",
                continuous_params=CONT if kind == "continuous" else None)


def _assert_bundles_equal(path_a, path_b):
    a, b = np.load(path_a, allow_pickle=False), np.load(path_b, allow_pickle=False)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        if k == "meta":
            assert json.loads(str(a[k])) == json.loads(str(b[k]))
            continue
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


FRONTEND = dict(n_filters=32, redundancy_factor=2, spike_thresholds=(0.6, 0.8))


@pytest.mark.parametrize("kind", ["dense", "sparse", "continuous"])
def test_reference_bundle_loads_in_the_port(tmp_path, kind):
    params, readout, st = _reference_params(kind)
    ref_path = tmp_path / "ref.npz"
    jmodel.save_model(ref_path, params, readout, st, jcfg.FrontendConfig(**FRONTEND), "original",
                      CLASSES, **_save_kwargs(kind))
    bundle = tmodel.load_model(ref_path, torch.device("cpu"))
    res = bundle.reservoir
    assert isinstance(res, SparseReservoir if kind == "sparse" else Reservoir)
    names = ("w_blocks", "src_idx", "w_in", "leak") if kind == "sparse" else ("w_rec", "w_in", "leak")
    for name in names:
        np.testing.assert_array_equal(getattr(res, name).numpy(), np.asarray(getattr(params, name)))
    for f in ("n_neurons", "n_outputs", "n_channels", "threshold", "refractory",
              "burst_isi_max", "n_rate_windows") + (("n_band",) if kind == "sparse" else ()):
        assert getattr(res, f) == getattr(params, f), f
    np.testing.assert_array_equal(bundle.readout.w.numpy(), np.asarray(readout.w))
    np.testing.assert_array_equal(bundle.scaler.scale.numpy(), np.asarray(st.scale))
    assert bundle.frontend == tcfg.FrontendConfig(**FRONTEND)
    assert bundle.class_names == CLASSES and bundle.feature_set == "original"
    assert bundle.feature_mode == _save_kwargs(kind)["feature_mode"]
    assert bundle.continuous_params == _save_kwargs(kind)["continuous_params"]

    # Saved again by the port: the same members, bit for bit, and meta.
    tmodel.save_model(tmp_path / "port.npz", bundle.reservoir, bundle.readout, bundle.scaler,
                      bundle.frontend, bundle.feature_set, bundle.class_names,
                      bundle.feature_mode, bundle.continuous_params)
    _assert_bundles_equal(ref_path, tmp_path / "port.npz")


@pytest.mark.parametrize("kind", ["dense", "sparse", "continuous"])
def test_port_bundle_loads_in_the_reference(tmp_path, kind):
    params, readout, st = _reference_params(kind)
    to_port = convert.sparse_reservoir if kind == "sparse" else convert.reservoir
    port_path = tmp_path / "port.npz"
    tmodel.save_model(port_path, to_port(params), convert.readout(readout), convert.scaler(st),
                      tcfg.FrontendConfig(**FRONTEND), "rate", CLASSES, **_save_kwargs(kind))
    bundle = jmodel.load_model(port_path)
    assert type(bundle.reservoir) is type(params)
    for name in ("w_blocks", "src_idx") if kind == "sparse" else ("w_rec",):
        got = np.asarray(getattr(bundle.reservoir, name))
        assert got.dtype == np.asarray(getattr(params, name)).dtype
        np.testing.assert_array_equal(got, np.asarray(getattr(params, name)))
    assert bundle.frontend == jcfg.FrontendConfig(**FRONTEND)
    assert bundle.feature_set == "rate" and bundle.class_names == CLASSES
    assert bundle.continuous_params == _save_kwargs(kind)["continuous_params"]
    jmodel.save_model(tmp_path / "ref.npz", params, readout, st,
                      jcfg.FrontendConfig(**FRONTEND), "rate", CLASSES, **_save_kwargs(kind))
    _assert_bundles_equal(tmp_path / "ref.npz", port_path)


def test_port_drawn_reservoir_saves_the_padded_buffers_only(tmp_path):
    """A reservoir the port drew itself: the padded float32 w_rec, w_in and
    leak go into the bundle, not the kernels' bf16 copies."""
    from lsm_tpu_torch.models.reservoir import init_reservoir
    from lsm_tpu_torch.readout.logistic import LogisticReadout
    from lsm_tpu_torch.readout.scaler import Scaler

    rcfg = tcfg.ReservoirConfig(num_neurons=200, num_output_neurons=100, small_world_k=40,
                                mean_weight=0.02)
    res = init_reservoir(rcfg, n_channels=20)
    d = 5 * 100
    tmodel.save_model(tmp_path / "m.npz", res, LogisticReadout(torch.zeros(d, 4), torch.zeros(4)),
                      Scaler(torch.zeros(d), torch.ones(d)), tcfg.FrontendConfig(), "original",
                      CLASSES)
    data = np.load(tmp_path / "m.npz")
    assert data["w_rec"].shape == (256, 256) and data["w_in"].shape == (128, 256)
    assert data["leak"].shape == (256,)
    assert {data[k].dtype for k in data.files if k != "meta"} == {np.dtype(np.float32)}
    back = tmodel.load_model(tmp_path / "m.npz", "cpu").reservoir
    assert torch.equal(back.w_rec_bf16, res.w_rec_bf16) and torch.equal(back.leak_keep, res.leak_keep)


def test_load_model_refusals(tmp_path):
    params, readout, st = _reference_params("dense")
    path = tmp_path / "m.npz"
    jmodel.save_model(path, params, readout, st, jcfg.FrontendConfig(), "original", CLASSES)
    with pytest.raises(FileNotFoundError):
        tmodel.load_model(tmp_path / "nope.npz", "cpu")

    data = np.load(path)
    meta = json.loads(str(data["meta"]))
    members = {k: data[k] for k in data.files if k != "meta"}
    np.savez(tmp_path / "bad.npz", meta=json.dumps({**meta, "format": "lsm_tpu.model.v99"}),
             **members)
    with pytest.raises(ValueError, match="unknown model format.*v99"):
        tmodel.load_model(tmp_path / "bad.npz", "cpu")

    # Frontend keys this build does not know are dropped, as
    # config.frontend_from_dict drops them.
    meta["frontend"]["new_knob"] = 3
    np.savez(tmp_path / "newer.npz", meta=json.dumps(meta), **members)
    assert tmodel.load_model(tmp_path / "newer.npz", "cpu").frontend == tcfg.FrontendConfig()

    res = convert.reservoir(params)
    for kw in ({"feature_mode": "stream"}, {"feature_mode": "continuous"}):
        with pytest.raises(ValueError):
            tmodel.save_model(tmp_path / "x.npz", res, convert.readout(readout),
                              convert.scaler(st), tcfg.FrontendConfig(), "original", CLASSES, **kw)
