"""Serving-state files (lsm_tpu_torch.io.serving_state) against lsm_tpu's
format on the CPU: the weights checksum and the meta header equal
lsm_tpu's on the same weights, files go both ways between the packages in
both engine modes, and within the port every save/load and migration
continues bit-exactly; every refusal of lsm_tpu's list raises ValueError.

Models, audio and tolerances are tests/test_torch_streaming.py's (dyadic
weights at a small width; continued logits rtol 1e-4 / atol 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsm_tpu.config import FEATURE_SETS, FrontendConfig, ReservoirConfig
from lsm_tpu.io import serving_state as jss
from lsm_tpu.models import reservoir as jres
from lsm_tpu.models import sparse as jsp
from lsm_tpu.models.continuous import ContinuousKWS as JaxCont
from lsm_tpu.models.streaming import StreamingKWS as JaxExact

from lsm_tpu_torch.io import serving_state as tss
from lsm_tpu_torch.models.continuous import ContinuousKWS
from lsm_tpu_torch.models.streaming import StreamingKWS
from lsm_tpu_torch.readout.logistic import LogisticReadout

from test_torch_streaming import (  # noqa: F401 (fixtures)
    _readout, assert_logits_match, audio, dense, engines, hop, port_engine, port_modules,
    sparse,
)

torch.set_num_threads(1)

KINDS = ("exact", "continuous")


# ---- identity -----------------------------------------------------------------

def test_leaf_fingerprint_equals_reference():
    """Both digest routes on the same values: the position-weighted sum of
    leaves >= 2^20 elements (4-byte words and bytes) and the bytes of
    smaller ones, from tensors and arrays alike."""
    rng = np.random.default_rng(0)
    n = tss._LARGE_LEAF
    assert n == jss._DEVICE_HASH_THRESHOLD == 1 << 20
    for a in (rng.standard_normal(n).astype(np.float32),
              rng.standard_normal(n + 3).astype(np.float32).reshape(-1, 1),
              rng.integers(-3000, 3000, n + 1).astype(np.int16),
              rng.integers(0, 1 << 30, (8, 13, 128, 128)).astype(np.int32),
              rng.standard_normal(64).astype(np.float32)):
        want = jss._leaf_fingerprint(jnp.asarray(a))
        assert tss._leaf_fingerprint(torch.as_tensor(a)) == want
        assert tss._leaf_fingerprint(a) == want == jss._leaf_fingerprint(a)


@pytest.fixture(scope="module")
def flagship_width():
    """lsm_tpu's dense draw at N_pad 1024 (the flagship's 1000 neurons):
    w_rec has exactly 2^20 elements, the large-leaf route."""
    params = jres.init_reservoir(ReservoirConfig(), n_channels=16)
    assert params.w_rec.size == 1 << 20
    return (params, *_readout(params.n_outputs), FrontendConfig(n_filters=16))


@pytest.fixture(scope="module")
def wide_sparse():
    """A block-sparse draw whose w_blocks reach the large-leaf route."""
    rc = ReservoirConfig(num_neurons=2048, num_output_neurons=64, small_world_k=410,
                         mean_weight=0.02, sparse=True)
    params = jsp.init_reservoir_sparse(rc, n_channels=16)
    assert params.w_blocks.size >= 1 << 20
    return (params, *_readout(64, seed=7), FrontendConfig(n_filters=16))


@pytest.mark.parametrize("which", ["dense", "flagship_width", "sparse", "wide_sparse"])
def test_weights_crc_equals_reference(request, which):
    model = request.getfixturevalue(which)
    params, ro, sc, fcfg = model
    j = JaxExact(params, ro, sc, fcfg, "original", 2)
    t = StreamingKWS(*port_modules(model), "original", 2)
    treedef = jax.tree_util.tree_flatten((params, ro, sc))[1]
    assert tss._treedef_text(t) == str(treedef)
    assert tss._weights_crc(t) == jss._weights_crc(j)
    assert t._serving_weights_crc == j._serving_weights_crc          # cached


@pytest.mark.parametrize("kind", KINDS)
def test_meta_equals_reference(dense, kind):
    j, t = engines(dense, kind)
    assert tss._engine_meta(t) == jss._engine_meta(j)
    if kind == "continuous":
        assert tss._engine_meta(t)["gtgram_two_phase"] is False       # the CPU twin ran


# ---- files across the packages ------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer", ["lsm_tpu", "port"])
def test_files_cross_between_packages(dense, audio, tmp_path, kind, writer):
    """One package serves 5 hops and saves; a fresh engine of the other
    loads the file; both then serve 3 more hops from the same state."""
    j, t = engines(dense, kind)
    src, save = (j, jss.save_serving_state) if writer == "lsm_tpu" else (t, tss.save_serving_state)
    for h in range(5):
        src.step(hop(audio, h, "int16"))
    path = tmp_path / "state.npz"
    save(path, src)
    j2, t2 = engines(dense, kind)
    dst, load = (t2, tss.load_serving_state) if writer == "lsm_tpu" else (j2, jss.load_serving_state)
    meta = load(path, dst)
    assert meta["engine"] == kind
    for h in range(5, 8):
        ch = hop(audio, h, "int16")
        ls, ld = src.step(ch), dst.step(ch)
        port, ref = (ld, ls) if writer == "lsm_tpu" else (ls, ld)
        assert_logits_match(port, ref)


def test_a_card_snapshot_is_refused_on_the_cpu(dense, tmp_path):
    """gtgram_two_phase is part of the identity: a file from an engine
    that ran the two-phase kernel (lsm_tpu's forced here, the port's on
    the card) does not load into a CPU engine, nor migrate into one."""
    params, ro, sc, fcfg = dense
    forced = JaxCont(params, ro, sc, fcfg, "original", 4, gtgram_two_phase=True)
    path = tmp_path / "card.npz"
    jss.save_serving_state(path, forced)
    t = port_engine(dense, "continuous")
    with pytest.raises(ValueError, match="gammatone dispatch"):
        tss.load_serving_state(path, t)
    card = port_engine(dense, "continuous")
    card.gtgram_two_phase = True
    with pytest.raises(ValueError, match="gammatone dispatch"):
        tss.migrate_streams(card, t, [0], [0])


# ---- within the port ------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("compress", [True, False])
def test_save_load_continues_bit_exactly(dense, audio, tmp_path, kind, compress):
    a = port_engine(dense, kind)
    for h in range(4):
        a.step(hop(audio, h, "ulaw"))
    path = tmp_path / "s.npz"
    tss.save_serving_state(path, a, compress=compress)
    b = port_engine(dense, kind)
    tss.load_serving_state(path, b)
    for h in range(4, 7):
        ch = hop(audio, h, "ulaw")
        np.testing.assert_array_equal(b.step(ch), a.step(ch))
    assert not (tmp_path / "s.npz.tmp").exists()


def _state_tensors(kws):
    """Every tensor of an engine's carried state, by its snapshot name."""
    if isinstance(kws, ContinuousKWS):
        st = kws.state
        out = {f.name: getattr(st, f.name) for f in dataclasses.fields(st) if f.name != "segs"}
        return {**out, **{f"seg:{k}": v for k, v in st.segs.items()}}
    return {k: v for k, v in vars(kws).items() if torch.is_tensor(v)}


@pytest.mark.parametrize("model", ["dense", "sparse"])
@pytest.mark.parametrize("kind", KINDS)
def test_leaf_table_names_every_state_tensor(request, audio, kind, model):
    """The engine's leaf table is its whole carried state: it names every
    state tensor, fresh and after hops, each with n_local rows on its
    stream axis and the table's dtype, and snapshot() holds exactly it."""
    kws = port_engine(request.getfixturevalue(model), kind, n_streams=3)
    for h in range(3):
        state = _state_tensors(kws)
        assert set(state) == {lf.name for lf in kws.LEAVES}
        for lf in kws.LEAVES:
            t = state[lf.name]
            assert t.shape[lf.axis] == kws.n_local and t.dtype == lf.dtype, lf.name
        kws.step(hop(audio, h)[:3])
    assert list(kws.snapshot()) == [lf.name for lf in kws.LEAVES]


@pytest.mark.parametrize("kind", KINDS)
def test_migrate_streams_bit_exact(dense, audio, kind):
    src, dst = port_engine(dense, kind), port_engine(dense, kind, n_streams=3)
    for h in range(3):
        src.step(hop(audio, h))
        dst.step(hop(audio, h + 5)[:3])
    untouched = dst.extract_streams([0])
    tss.migrate_streams(src, dst, [2, 0], [1, 2])
    for k, v in dst.extract_streams([0]).items():
        np.testing.assert_array_equal(v, untouched[k], err_msg=k)
    for h in range(3, 6):
        ch = hop(audio, h)
        ls = src.step(ch)
        ld = dst.step(np.stack([ch[1], ch[2], ch[0]]))
        np.testing.assert_array_equal(ld[[1, 2]], ls[[2, 0]])


def test_migration_refusals(dense):
    a = port_engine(dense, "continuous")
    with pytest.raises(ValueError, match="engine mode"):
        tss.migrate_streams(a, port_engine(dense, "exact"), [0], [0])
    with pytest.raises(ValueError, match="model weights"):
        tss.migrate_streams(port_engine(dense, "exact"), StreamingKWS(*_swapped(dense), "original", 4),
                            [0], [0])
    for src_idx, dst_idx, what in (([0, 1], [0], "pair up"), ([4], [0], "src_idx out of range"),
                                   ([0], [-1], "dst_idx out of range"),
                                   ([0, 1], [2, 2], "duplicate")):
        with pytest.raises(ValueError, match=what):
            tss.migrate_streams(a, port_engine(dense, "continuous"), src_idx, dst_idx)


def _swapped(model):
    res, ro, sc, fcfg = port_modules(model)
    return res, LogisticReadout(ro.w, ro.b + 1e-3), sc, fcfg


def _refusals(model, tmp_path):
    """(file, engine, message) for every refusal of lsm_tpu's list."""
    res, ro, sc, fcfg = port_modules(model)
    src = port_engine(model, "continuous")
    path = tmp_path / "state.npz"
    tss.save_serving_state(path, src)
    trunc = tmp_path / "trunc.npz"
    trunc.write_bytes(path.read_bytes()[: path.stat().st_size // 2])
    foreign = tmp_path / "foreign.npz"
    np.savez(foreign, meta='{"format": "lsm_tpu.serving_state.v1"}')
    bogus = tmp_path / "bogus.npz"
    np.savez(bogus, x=np.zeros(3))
    d = len(FEATURE_SETS["all"]) * res.n_outputs
    two_phase = port_engine(model, "continuous")
    two_phase.gtgram_two_phase = True
    return [
        (path, port_engine(model, "exact"), "engine mode"),
        (path, port_engine(model, "continuous", n_streams=3), "stream count"),
        (path, ContinuousKWS(res, LogisticReadout(torch.zeros(d, 4), torch.zeros(4)),
                             type(sc)(torch.zeros(d), torch.ones(d)), fcfg, "all", 4),
         "feature set"),
        (path, port_engine(model, "continuous", chunk_len=3200), "chunk length"),
        (path, port_engine(model, "continuous", norm_decay_db_per_bin=0.2), "normalization decay"),
        (path, two_phase, "gammatone dispatch"),
        (path, ContinuousKWS(res, ro, sc, dataclasses.replace(fcfg, hysteresis_gap=0.2),
                             "original", 4), "frontend"),
        (path, ContinuousKWS(*_swapped(model), "original", 4), "different model weights"),
        (trunc, src, "corrupt or truncated"),
        (foreign, src, "has format"),
        (bogus, src, "not a serving-state snapshot"),
    ]


REFUSAL_IDS = ["engine", "streams", "features", "chunk", "decay", "two_phase", "frontend",
               "weights", "truncated", "foreign", "bogus"]


@pytest.mark.parametrize("case", range(len(REFUSAL_IDS)), ids=REFUSAL_IDS)
def test_every_refusal_raises_value_error(dense, tmp_path, case):
    path, kws, message = _refusals(dense, tmp_path)[case]
    before = kws.snapshot()
    with pytest.raises(ValueError, match=message):
        tss.load_serving_state(path, kws)
    for k, v in kws.snapshot().items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


def test_restore_refuses_bad_leaves(dense):
    t = port_engine(dense, "continuous")
    snap = t.snapshot()
    with pytest.raises(ValueError, match="snapshot leaf 'v'"):
        t.restore({**snap, "v": snap["v"][:, :-1]})
    with pytest.raises(ValueError, match="missing state leaf"):
        t.restore({k: v for k, v in snap.items() if k != "norm_hi"})
    with pytest.raises(ValueError, match="does not track"):
        t.restore({**snap, "seg:bogus": np.zeros(1, np.float32)})
    e = port_engine(dense, "exact")
    with pytest.raises(ValueError, match="float32"):
        e.restore({"buffer": np.zeros((4, 100), np.float32)})
    with pytest.raises(ValueError, match="missing state leaf 'buffer'"):
        e.restore({})


def test_swap_readout_invalidates_the_checksum(dense, tmp_path):
    t = port_engine(dense, "exact")
    path = tmp_path / "s.npz"
    tss.save_serving_state(path, t)
    crc = tss._weights_crc(t)
    res, ro, sc, _ = _swapped(dense)
    t.swap_readout(ro)
    assert tss._weights_crc(t) != crc
    with pytest.raises(ValueError, match="different model weights"):
        tss.load_serving_state(path, t)
