"""The port's StreamPool (lsm_tpu_torch.models.pool) against lsm_tpu's on
the CPU: one admit/step/finish/drain/save/restore script drives both
packages' pools over both engines, on the same converted weights and the
same audio; predictions must be equal (where the reference's margin is
sure, > 1e-3) and margins within float16 rounding of the reference's
(rtol 2e-3, atol 1e-4: one float16 step is 2^-11 relative, and the logits
themselves agree to rtol 1e-4). PoolFullError is raised where lsm_tpu's
is. Within the port, pool decisions equal a directly driven engine's.

Models and audio are tests/test_torch_streaming.py's.
"""

import numpy as np
import pytest
import torch

from lsm_tpu.models import pool as jpool

from lsm_tpu_torch.models import pool as tpool
from lsm_tpu_torch.models.streaming import wire_silence

from test_torch_streaming import audio, dense, engines, hop, L  # noqa: F401 (fixtures)

torch.set_num_threads(1)


def _script(pool_mod, make, audio, tmp_path):
    """The lifecycle on one package; returns every decision in order and
    where PoolFullError was raised."""
    out = []
    tmp_path.mkdir()
    pool = pool_mod.StreamPool(make(), chunk_len=L)
    other = pool_mod.StreamPool(make(2), chunk_len=L)
    full = []
    for s in ("a", "b", "c", "d"):
        pool.admit(s)
    try:
        pool.admit("e")
    except pool_mod.PoolFullError:
        full.append("admit e")
    pool.finish("b")
    pool.admit("e")                               # b's slot, reset
    for h in range(6):
        feed = {s: hop(audio, h, "int16")[i] for i, s in enumerate(("a", "c", "e", "d"))
                if (h + i) % 3}                   # a third of the sessions silent each hop
        out.append(pool.step(feed))
    out.append(pool.step({}))                     # nobody speaks
    pool.save(tmp_path / "pool.npz")
    pool = pool_mod.StreamPool.restore(tmp_path / "pool.npz", make())
    out.append(pool.step({"e": hop(audio, 6, "int16")[1]}))
    pool.drain(["a", "e"], other)
    try:
        pool.drain(["c"], other)
    except pool_mod.PoolFullError:
        full.append("drain c")
    for h in range(7, 9):
        out.append(other.step({"a": hop(audio, h, "int16")[0], "e": hop(audio, h, "int16")[2]}))
        out.append(pool.step({"c": hop(audio, h, "int16")[1]}))
    out.append(pool.diagnostics()[1])
    return out, full


@pytest.mark.parametrize("kind", ["exact", "continuous"])
def test_pool_script_matches_reference(dense, audio, tmp_path, kind):
    def maker(i):
        return lambda n=4: engines(dense, kind, n)[i]

    ref, ref_full = _script(jpool, maker(0), audio, tmp_path / "j")
    port, port_full = _script(tpool, maker(1), audio, tmp_path / "t")
    assert port_full == ref_full == ["admit e", "drain c"]
    assert len(port) == len(ref)
    for p, r in zip(port[:-1], ref[:-1]):
        assert list(p) == list(r)
        for s in r:
            (pp, mp), (pr, mr) = p[s], r[s]
            if mr > 1e-3:
                assert pp == pr, (s, p, r)
            np.testing.assert_allclose(mp, mr, rtol=2e-3, atol=1e-4)
    assert list(port[-1]) == list(ref[-1]) == ["c", "d"]     # diagnostics per session
    for s in ("c", "d"):
        np.testing.assert_allclose(port[-1][s], ref[-1][s], rtol=1e-6)


@pytest.mark.parametrize("kind", ["exact", "continuous"])
def test_pool_equals_the_engine_driven_directly(dense, audio, kind):
    """Every pool decision is step_compact of an engine fed full chunks
    with wire silence in the unfed rows; a finished slot is recycled."""
    pool = tpool.StreamPool(engines(dense, kind)[1], chunk_len=L)
    ref = engines(dense, kind)[1]
    assert pool.admit("x") == 0 and pool.admit("y") == 1
    for h in range(3):
        ch = hop(audio, h, "ulaw")
        got = pool.step({"y": ch[1]} if h == 1 else {"x": ch[0], "y": ch[1]})
        full = np.full_like(ch, wire_silence(np.uint8))
        full[1] = ch[1]
        if h != 1:
            full[0] = ch[0]
        preds, margins = ref.step_compact(full)
        assert got == {"x": (int(preds[0]), float(margins[0])),
                       "y": (int(preds[1]), float(margins[1]))}
    pool.finish("x")
    ref.reset(0)
    assert pool.admit("z") == 0
    for k, v in ref.snapshot().items():
        np.testing.assert_array_equal(pool.kws.snapshot()[k], v, err_msg=k)


def test_pool_guards(dense, audio):
    pool = tpool.StreamPool(engines(dense, "exact")[1])
    pool.admit("a")
    with pytest.raises(ValueError, match="already admitted"):
        pool.admit("a")
    with pytest.raises(ValueError, match="all-silent hop"):
        pool.step({})
    with pytest.raises(KeyError, match="not admitted"):
        pool.step({"b": hop(audio, 0)[0]})
    pool.admit("b")
    with pytest.raises(ValueError, match="mixed wire dtypes"):
        pool.step({"a": hop(audio, 0)[0], "b": hop(audio, 0, "int16")[1]})
    pool.admit(("not", "json"))
    with pytest.raises(TypeError, match="JSON scalar"):
        pool.save("unused.npz")
    with pytest.raises(ValueError, match="duplicate session ids"):
        pool.drain(["a", "a"], tpool.StreamPool(engines(dense, "exact")[1]))


def test_pool_restore_refusals(dense, tmp_path):
    from lsm_tpu_torch.io.serving_state import save_serving_state

    kws = engines(dense, "continuous")[1]
    save_serving_state(tmp_path / "engine.npz", kws)
    with pytest.raises(ValueError, match="no pool session table"):
        tpool.StreamPool.restore(tmp_path / "engine.npz", kws)
    pool = tpool.StreamPool(kws)
    pool.admit("a")
    pool.save(tmp_path / "pool.npz")
    with pytest.raises(ValueError, match="do not partition"):
        tpool.StreamPool.restore(tmp_path / "pool.npz", engines(dense, "continuous", 3)[1])
