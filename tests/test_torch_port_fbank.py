"""Port parity: kernel 1 (int8-DFT fbank DSP) and the streaming accept.

The port's plain `fbank_i8` (april_asr_tpu_torch/ops/fbank_kernels.py) is
held against the JAX package's Pallas kernel `logmel_rows_from_buf_i8` run
in interpret mode, and the port's `fbank_accept_batch` against the JAX one
on the same path (APRIL_PALLAS=1, S a multiple of the kernels' 8-session
tile): the int8 DFT (`dft_i8=True`, int8 engines) and the bf16x3 DFT of
kernel 5 (`dft_i8=False`, every other engine; the kernel itself is tested in
tests/test_torch_port_float.py). Both sides split the samples exactly into
int8 (or bf16) planes and sum exact products, so they differ only in f32
summation order: the bound is tests/test_fbank_pallas.py's atol=2e-5,
rtol=1e-4. Against the float64 oracle the frontend budget is 2e-3 (the int8
DFT's own error, measured ~1.4e-3 worst case in the JAX package's notes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.config import FbankOptions as JFbankOptions
from april_asr_tpu.frontend import fbank as jfb
from april_asr_tpu.ops.fbank_pallas import logmel_rows_from_buf_i8 as j_logmel_i8
from april_asr_tpu_torch.config import FbankOptions
from april_asr_tpu_torch.frontend import fbank as tfb
from april_asr_tpu_torch.frontend.oracle import OracleFbank
from april_asr_tpu_torch.ops.fbank_kernels import logmel_rows_from_buf_i8

S = 8


def _pcm(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 0.25, shape) * 32768).clip(-32768, 32767).astype(np.int16)
    return x.astype(np.float32) / 32768.0


@pytest.mark.parametrize("chunk", [3200, 16000])
def test_fbank_i8_plain_matches_jax_interpret(chunk):
    jl = jfb.FbankLayout.build(JFbankOptions(), chunk)
    tl = tfb.FbankLayout.build(FbankOptions(), chunk)
    assert (tl.max_frames, tl.buf_len, tl.fifo_rows) == (
        jl.max_frames,
        ((jl.leftover_cap + chunk + 4 * 160 + 159) // 160) * 160,
        jl.fifo_rows,
    )
    buf = _pcm((S, tl.buf_len), seed=chunk)
    want = np.asarray(j_logmel_i8(jl, jnp.asarray(buf), interpret=True))
    got = logmel_rows_from_buf_i8(tl, torch.from_numpy(buf)).numpy()
    assert got.shape == want.shape == (S, tl.max_frames, 80)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def _run_accepts(monkeypatch, chunk, sizes, seed, dft_i8):
    jl = jfb.FbankLayout.build(JFbankOptions(), chunk)
    tl = tfb.FbankLayout.build(FbankOptions(), chunk)
    waves = _pcm((S, sum(sizes)), seed)
    monkeypatch.setenv("APRIL_PALLAS", "1")
    jst = jax.vmap(lambda _: jfb.fbank_init(jl))(jnp.arange(S))
    jaccept = jax.jit(lambda s, w, n: jfb.fbank_accept_batch(jl, s, w, n, dft_i8=dft_i8))
    tst = tfb.fbank_init(tl, S, "cpu")
    o = 0
    for k, sz in enumerate(sizes):
        w = np.zeros((S, chunk), np.float32)
        # mixed feed lengths across sessions in one step
        n = np.array([sz if (s + k) % 3 else max(sz - 333, 0) for s in range(S)], np.int32)
        for s in range(S):
            w[s, : n[s]] = waves[s, o : o + n[s]]
        o += sz
        jst = jaccept(jst, jnp.asarray(w), jnp.asarray(n))
        tst = tfb.fbank_accept_batch(tl, tst, torch.from_numpy(w), torch.from_numpy(n), dft_i8)
    return jl, jst, tst, waves


ACCEPTS = [(3200, [3200, 777, 3200, 1501, 2900]), (16000, [16000, 9001, 16000])]


@pytest.mark.parametrize("chunk,sizes", ACCEPTS)
def test_accept_batch_matches_jax(monkeypatch, chunk, sizes):
    _check_accepts(monkeypatch, chunk, sizes, dft_i8=True)


@pytest.mark.parametrize("chunk,sizes", ACCEPTS)
def test_accept_batch_float_matches_jax(monkeypatch, chunk, sizes):
    _check_accepts(monkeypatch, chunk, sizes, dft_i8=False)


def _check_accepts(monkeypatch, chunk, sizes, dft_i8):
    jl, jst, tst, _ = _run_accepts(monkeypatch, chunk, sizes, seed=11, dft_i8=dft_i8)
    for k in ("fifo_len", "fifo_off", "fifo_len_f", "leftover_len", "dropped"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]), err_msg=k)
    # the leftover is moved, never computed: it is the same samples
    np.testing.assert_allclose(tst["leftover"].numpy(), np.asarray(jst["leftover"]), atol=1e-6)
    R = jl.fifo_rows
    jf, tf = np.asarray(jst["fifo"]), tst["fifo"].numpy()
    for s in range(S):
        off, ln = int(jst["fifo_off"][s]), int(jst["fifo_len"][s])
        idx = [(off + i) % R for i in range(ln)]
        np.testing.assert_allclose(tf[s, idx], jf[s, idx], atol=2e-5, rtol=1e-4)


def test_accept_batch_matches_f64_oracle():
    """Streaming rows (hop-unaligned feeds, leftover carry) within 2e-3 of
    the float64 oracle, and the same row count: the int8 DFT."""
    _check_oracle(dft_i8=True)


def test_accept_batch_float_matches_f64_oracle():
    """The same for the bf16x3 DFT (kernel 5)."""
    _check_oracle(dft_i8=False)


def _check_oracle(dft_i8):
    chunk = 3200
    tl = tfb.FbankLayout.build(FbankOptions(), chunk)
    sizes = [3200, 777, 3200, 1501]
    waves = _pcm((S, sum(sizes)), seed=5)
    st = tfb.fbank_init(tl, S, "cpu")
    rows = [[] for _ in range(S)]
    o = 0
    for sz in sizes:
        w = np.zeros((S, chunk), np.float32)
        w[:, :sz] = waves[:, o : o + sz]
        o += sz
        before = st["fifo_len"].clone()
        st = tfb.fbank_accept_batch(tl, st, torch.from_numpy(w),
                                    torch.full((S,), sz, dtype=torch.int32), dft_i8)
        for s in range(S):
            for i in range(int(before[s]), int(st["fifo_len"][s])):
                rows[s].append(st["fifo"][s, (int(st["fifo_off"][s]) + i) % tl.fifo_rows].numpy())
        pulls = torch.clamp(torch.div(st["fifo_len"] - 9, 4, rounding_mode="floor") + 1, min=0)
        st = tfb.fbank_advance_n(tl, st, pulls)
    for s in range(S):
        ob = OracleFbank(FbankOptions())
        ob.accept_waveform(waves[s])
        ref = np.stack(ob.fifo)
        got = np.stack(rows[s])
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() < 2e-3


@pytest.mark.parametrize("dft_i8", [True, False])
@pytest.mark.parametrize("n_sessions,kernel", [(1, False), (4, False), (8, True), (16, True)])
def test_accept_route_follows_jax_gate(monkeypatch, n_sessions, kernel, dft_i8):
    """The JAX package's gate (`fused_supported`, fbank_pallas.py:190-191):
    at S a multiple of 8 the frontend takes kernel 1 (`dft_i8`) or kernel 5;
    at any other S the f32 DFT (`_frame_dsp`), as JAX's `fbank_accept`."""
    from april_asr_tpu_torch.ops import fbank_kernels as FK

    calls = []
    for name in ("logmel_rows_from_buf_i8", "logmel_rows_from_buf", "logmel_rows_fused"):
        orig = getattr(FK, name)
        monkeypatch.setattr(FK, name, lambda *a, orig=orig, name=name: (
            calls.append(name), orig(*a))[1])
    orig_dsp = tfb._frame_dsp
    monkeypatch.setattr(tfb, "_frame_dsp", lambda *a: (calls.append("_frame_dsp"), orig_dsp(*a))[1])
    tl = tfb.FbankLayout.build(FbankOptions(), 3200)
    assert FK.fused_supported(tl, n_sessions) == kernel
    w = _pcm((n_sessions, 3200), seed=n_sessions)
    st = tfb.fbank_accept_batch(tl, tfb.fbank_init(tl, n_sessions, "cpu"), torch.from_numpy(w),
                                torch.full((n_sessions,), 3200, dtype=torch.int32), dft_i8)
    want = ("logmel_rows_from_buf_i8" if dft_i8 else "logmel_rows_from_buf") if kernel \
        else "_frame_dsp"
    assert calls == [want]
    assert (st["fifo_len"] > 0).all()


def test_frame_dsp_matches_jax():
    """The f32 DFT route against JAX's `fbank_accept` under vmap (its route
    at S % 8 != 0 with or without APRIL_PALLAS) on hop-unaligned feeds: the
    integer state equal, the rows within the fbank bound."""
    S, chunk, sizes = 3, 3200, [3200, 777, 3200, 1501]
    jl = jfb.FbankLayout.build(JFbankOptions(), chunk)
    tl = tfb.FbankLayout.build(FbankOptions(), chunk)
    waves = _pcm((S, sum(sizes)), seed=21)
    jaccept = jax.jit(jax.vmap(lambda s, w, n: jfb.fbank_accept(jl, s, w, n)))
    jst = jax.vmap(lambda _: jfb.fbank_init(jl))(jnp.arange(S))
    tst = tfb.fbank_init(tl, S, "cpu")
    o = 0
    for sz in sizes:
        w = np.zeros((S, chunk), np.float32)
        w[:, :sz] = waves[:, o : o + sz]
        o += sz
        n = np.full(S, sz, np.int32)
        jst = jaccept(jst, jnp.asarray(w), jnp.asarray(n))
        tst = tfb.fbank_accept(tl, tst, torch.from_numpy(w), torch.from_numpy(n))
    for k in ("fifo_len", "fifo_off", "fifo_len_f", "leftover_len", "dropped"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]), err_msg=k)
    np.testing.assert_allclose(tst["fifo"].numpy(), np.asarray(jst["fifo"]), atol=2e-5, rtol=1e-4)
