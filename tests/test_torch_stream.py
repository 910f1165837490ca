"""``TTS.stream(mode="growing")`` against the JAX package's, chunk for
chunk, greedy: each chunk re-vocodes the whole prefix with HiFiGAN, the
reference's exact behaviour, from the same decode as the windowed mode.
Tolerance 1e-4, as the windowed stream's test (HiFiGAN's fp32
convolutions sum in other orders)."""

import numpy as np
import pytest

from tests.torch_pair import make_pair

STEPS = 130          # three chunks: 60, 40, 30


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    jtts, ttts, ref, _ = make_pair(tmp_path_factory.mktemp("stream"), mp)
    yield jtts, ttts, ref
    mp.undo()


def test_stream_growing_matches_jax(pair):
    jtts, ttts, ref = pair
    kw = dict(max_ar_steps=STEPS, greedy=True, seed=2, mode="growing",
              length_penalty=2.0)
    jchunks = list(jtts.stream("hello world, this is a test.", ref, **kw))
    tchunks = list(ttts.stream("hello world, this is a test.", ref, **kw))
    assert len(tchunks) == len(jchunks) == 3
    assert [c.shape for c in tchunks] == [c.shape for c in jchunks]
    for a, b in zip(tchunks, jchunks):
        assert a.dtype == np.float32 and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=1e-4)
    with pytest.raises(ValueError, match="windowed|growing"):
        next(ttts.stream("hi", ref, mode="whole"))
