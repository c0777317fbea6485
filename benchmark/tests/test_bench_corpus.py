"""The benchmark's copies of the synthetic corpora equal the port's, and its
traffic is a function of the seed."""

import numpy as np
import pytest

from benchmark.lib import corpus
from lsm_tpu_torch.io import dataset


@pytest.mark.parametrize("name", ["synthetic_audio_batch", "synthetic_audio_batch_hard"])
@pytest.mark.parametrize("seed", [0, 42, 2**33 + 5])
def test_copies_equal_the_port(name, seed):
    ours = getattr(corpus, name)(2, 12, seed=seed)
    port = getattr(dataset, name)(2, 12, seed=seed)
    for a, b in zip(ours, port):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_pool_is_the_seed_and_workers_do_not_change_it():
    args = ("hard", 3, 1, 4, 2**31 + 17)
    with corpus.Pool(*args, workers=1) as p:
        one = p.result()
    with corpus.Pool(*args, workers=2) as p:
        two = p.result()
    np.testing.assert_array_equal(one, two)
    with corpus.Pool("hard", 3, 1, 4, 2**31 + 18, workers=1) as p:
        assert not np.array_equal(one, p.result())
    assert one.shape == (12, 16000)
    np.testing.assert_array_equal(one[4:8], corpus.synthetic_audio_batch_hard(
        1, 4, seed=corpus.part_seed(2**31 + 17, 1))[0])


def test_stream_schedule_plays_utterances_back_to_back():
    wire = corpus.to_wire(corpus.synthetic_audio_batch_hard(1, 4, seed=3)[0])
    s = corpus.StreamSchedule(wire, 6, 1600, 30, seed=9)
    for stream in range(6):
        audio = np.concatenate([s.chunk(h)[stream] for h in range(30)])
        start = s.phase[stream] * 1600
        first = wire[s.seq[stream, 0]][start:]
        np.testing.assert_array_equal(audio[:first.size], first)
        np.testing.assert_array_equal(audio[first.size:first.size + 16000], wire[s.seq[stream, 1]])
    assert s.chunk(3).flags["C_CONTIGUOUS"] and s.chunk(3).shape == (6, 1600)
    np.testing.assert_array_equal(s.chunk(31), s.chunk(1))
