"""Port parity: the host runtime (april_asr_tpu_torch/native), the SPSC
audio ring and the time stretcher of the asynchronous sessions.

Both packages load the repository's `native/april_native.cc`; the port
builds it with g++ into its kernels' build directory. The port's ring and
stretcher are held against the JAX package's on the native library with
the same push and pull sequences: the same acceptances, samples, drop
counts and, across a producer and a consumer thread, the same stream; the
stretcher's output equal bit for bit at speeds 1.0 to 3.0, streamed in
chunks and at flush. The port's NumPy versions (`NumpyRing`,
`NumpyStretcher`, the tests' plain versions) are held bit for bit against
the JAX package's NumPy fallback (its `load_native` made to return None).
A failed build raises.
"""

import threading

import numpy as np
import pytest

import april_asr_tpu.native as JN
from april_asr_tpu_torch import native as TN

SPEEDS = (1.0, 1.25, 1.5, 2.0, 3.0)
RATE = 16000


def _voiced(n, seed):
    """A pitched vowel-like signal with noise, so the stretcher finds a
    period."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.7 * t)
    x = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / RATE) / k for k in range(1, 6))
    return ((0.3 * x + rng.normal(0, 0.02, n)) * 20000).clip(-32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def jax_native():
    lib = JN.load_native()
    if lib is None:
        pytest.fail("the JAX package could not build native/april_native.cc")
    return lib


def _ring_ops(ring, seq):
    out = []
    for op, arg in seq:
        if op == "push":
            out.append(("push", ring.push(arg)))
        else:
            out.append(("pull", ring.pull(arg).tolist()))
        out.append(("state", ring.available, ring.dropped))
    return out


def _ring_seq(seed):
    rng = np.random.default_rng(seed)
    seq = []
    for _ in range(60):
        if rng.random() < 0.6:
            seq.append(("push", rng.integers(-32768, 32767, int(rng.integers(1, 700)),
                                             dtype=np.int16)))
        else:
            seq.append(("pull", int(rng.integers(1, 900))))
    return seq


@pytest.mark.parametrize("seed", [0, 1])
def test_ring_matches_jax_native(jax_native, seed):
    cap = 1000
    seq = _ring_seq(seed)
    t, j = TN.AudioRing(cap), JN.AudioRing(cap)
    assert j._lib is not None
    got, want = _ring_ops(t, seq), _ring_ops(j, seq)
    assert got == want
    assert any(op == ("push", False) for op in got)  # overflow exercised
    assert t.dropped == j.dropped > 0
    t.close()
    j.close()


def _threaded_stream(ring, blocks):
    """Producer pushes `blocks` (retrying a rejected block), consumer pulls
    until every sample arrived; returns the samples pulled in order."""
    total = sum(len(b) for b in blocks)
    got = []

    def produce():
        for b in blocks:
            while not ring.push(b):
                pass

    def consume():
        n = 0
        while n < total:
            x = ring.pull(257)
            n += len(x)
            got.append(x)

    threads = [threading.Thread(target=produce), threading.Thread(target=consume)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    return np.concatenate(got)


def test_ring_threads_match_jax_native(jax_native):
    rng = np.random.default_rng(4)
    blocks = [rng.integers(-32768, 32767, int(rng.integers(50, 400)), dtype=np.int16)
              for _ in range(400)]
    want = np.concatenate(blocks)
    for ring in (TN.AudioRing(1024), JN.AudioRing(1024)):
        np.testing.assert_array_equal(_threaded_stream(ring, blocks), want)
        assert ring.available == 0
        ring.close()


def _stretch(st, pcm, speed, chunk=1600):
    st.set_speed(speed)
    out = [st.process(pcm[o : o + chunk]) for o in range(0, len(pcm), chunk)]
    out.append(st.process(np.zeros(0, np.int16), flush=True))
    return np.concatenate(out)


@pytest.mark.parametrize("speed", SPEEDS)
def test_stretcher_matches_jax_native(jax_native, speed):
    pcm = _voiced(RATE * 2, seed=int(speed * 4))
    t, j = TN.TimeStretcher(RATE), JN.TimeStretcher(RATE)
    got, want = _stretch(t, pcm, speed), _stretch(j, pcm, speed)
    np.testing.assert_array_equal(got, want)
    if speed > 1.0:
        assert abs(len(got) - len(pcm) / speed) < 0.05 * len(pcm)
    t.close()
    j.close()


@pytest.fixture()
def jax_numpy(monkeypatch):
    """The JAX package's classes on their NumPy fallback."""
    monkeypatch.setattr(JN, "load_native", lambda: None)


def test_numpy_ring_matches_jax_fallback(jax_numpy):
    seq = _ring_seq(2)
    j = JN.AudioRing(1000)
    assert j._lib is None
    assert _ring_ops(TN.NumpyRing(1000), seq) == _ring_ops(j, seq)


@pytest.mark.parametrize("speed", SPEEDS)
def test_numpy_stretcher_matches_jax_fallback(jax_numpy, speed):
    pcm = _voiced(RATE, seed=int(speed * 8))
    j = JN.TimeStretcher(RATE)
    assert j._lib is None
    np.testing.assert_array_equal(_stretch(TN.NumpyStretcher(RATE), pcm, speed, 1000),
                                  _stretch(j, pcm, speed, 1000))


def test_build_failure_raises(tmp_path, monkeypatch):
    """Without g++ the library is not built and the port says so; it does
    not go on on NumPy."""
    monkeypatch.setenv("APRIL_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        TN.build_native()
    assert not list(tmp_path.glob("*.so"))


def test_library_builds_where_asked(tmp_path, monkeypatch):
    monkeypatch.setenv("APRIL_TORCH_BUILD_DIR", str(tmp_path))
    path, _, _ = TN.build_native()
    assert path.parent == tmp_path and path.exists()
    assert TN.build_native()[1:] == ("", 0.0)  # built once
