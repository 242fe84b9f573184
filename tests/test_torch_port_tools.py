"""Port parity: the profiling tools' kernels, 23 (profile_int8's three
matrix-unit bodies) and 22 (profile_chunk_split's tile-interleaved int8
recurrent core), the ported tools end to end, and the repairs of the
port's API (Model/load_model argument order, init/version, the debug-audio
hook), and the engine-parting count that `tools/parent_ab.py` and
`tools/parting_witness.py` share (`testing.check_parting`).

The JAX side runs the tools' own Pallas kernels in interpret mode
(`pltpu.force_tpu_interpret_mode()`), each body wrapped in
`pl.pallas_call(body, out_shape=...)` as the tool's `call` does; the port
its plain versions, on the same inputs drawn with numpy. Bounds:

* int8: equal element for element (exact int32 sums).
* dynq: the quantized values and the int32 sums equal, the output to f32
  ulps (`_assert_ulp_close`). XLA compiles the body's `amax / 127.0` as a
  multiply by f32(1/127), and the port does the same.
* bf16: the products of two bf16 values are exact in f32, so each side
  differs from the float64 sum only by its f32 accumulation order: the
  worst-case bound K * 2^-24 * (|x| @ |w|) for a sum of K terms, held by
  both sides.
* Kernel 22 (kernel 13's contract): hseq to `_assert_ulp_close`, h and c
  after the last step to `_assert_stat_close`, as
  tests/test_torch_port_chunk_variants.py holds kernel 13, for the same
  reason (the JAX kernel fuses its gates in one XLA expression, and a
  flipped int8 rounding compounds over the recurrence).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import april_asr_tpu
import april_asr_tpu_torch
from april_asr_tpu.api.model import Model as JModel
from april_asr_tpu.api.session import Session as JSession
from april_asr_tpu.models import lstm_transducer as JM
from april_asr_tpu.models.loader import load_model as j_load_model
from april_asr_tpu_torch.api import Model, Session
from april_asr_tpu_torch.models import lstm_transducer as TM
from april_asr_tpu_torch.models.convert import from_jax_params
from april_asr_tpu_torch.models.export import make_model_parameters, save_april
from april_asr_tpu_torch.models.loader import load_model
from april_asr_tpu_torch.testing import default_tokens
from april_asr_tpu_torch.tools import profile_chunk_split as PCS
from april_asr_tpu_torch.tools import profile_int8 as PI8
from test_torch_port_lstm import _assert_stat_close, _assert_ulp_close
from tools import profile_chunk_split as JPCS
from tools import profile_int8 as JPI8

JAX_BODY = {"mm_bf16": (JPI8.mm_kernel, jnp.float32), "mm_i8": (JPI8.mm_kernel_i8, jnp.int32),
            "mm_i8_dynq": (JPI8.mm_kernel_i8_dynq, jnp.float32)}


def _jax_call(name, M, N, ins):
    body, dt = JAX_BODY[name]
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct((M, N), dt))(*ins))


def _jax_inputs(ins: dict) -> dict:
    """The port's tensors as JAX arrays (bf16 through an exact f32 view)."""
    out = {}
    for k, v in ins.items():
        a = jnp.asarray(v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy())
        out[k] = a.astype(jnp.bfloat16) if v.dtype == torch.bfloat16 else a
    return out


def _dynq_rows(x):
    """The first lines of `mm_kernel_i8_dynq`: (xq int8, sx)."""
    xf = x.astype(jnp.float32)
    sx = jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0
    return jnp.round(xf / jnp.maximum(sx, 1e-30)).astype(jnp.int8), sx


@pytest.mark.parametrize("shape", PI8.TINY_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", PI8.BODIES)
def test_matmul_body_matches_jax(name, shape):
    M, K, N = shape
    ins = PI8.make_inputs(M, K, N, "cpu", seed=M)
    jins = _jax_inputs(ins)
    args = PI8.body_args(name, ins)
    jargs = tuple(jins[k] for k in {"mm_bf16": ("x16", "w16"), "mm_i8": ("xi", "wi"),
                                    "mm_i8_dynq": ("x16", "wi", "ws")}[name])
    got = PI8.KERNEL[name](*args).numpy()
    want = _jax_call(name, M, N, jargs)
    assert got.dtype == want.dtype and got.shape == want.shape == (M, N)
    if name == "mm_i8":
        np.testing.assert_array_equal(got, want)
    elif name == "mm_i8_dynq":
        # the body's quantization, compiled by XLA outside the kernel
        jq, sx = jax.jit(_dynq_rows)(jins["x16"])
        jq = np.asarray(jq)
        q, tsx = PI8.dynq_rows(ins["x16"])
        np.testing.assert_array_equal(q.numpy().astype(np.int8), jq)
        np.testing.assert_array_equal(tsx.numpy(), np.asarray(sx))
        jacc = np.asarray(jnp.dot(jq, jins["wi"], preferred_element_type=jnp.int32))
        np.testing.assert_array_equal(PI8.mm_i8(q.to(torch.int8), ins["wi"]).numpy(), jacc)
        _assert_ulp_close(got, want, "mm_i8_dynq")
    else:
        x, w = (a.double().numpy() for a in args)
        exact = x @ w
        tol = K * 2.0**-24 * (np.abs(x) @ np.abs(w))
        for side, v in (("port", got), ("jax", want)):
            assert (np.abs(v - exact) <= tol).all(), f"mm_bf16 {side} beyond K * 2^-24 * (|x| @ |w|)"


# kernel 22 at small widths: one layer, d 16, hidden 32
IP, IS, IBLOCK = 5, 16, 8
IDIMS = JM.TransducerDims(layers=1, d_model=16, hidden=32, ffn=24, mel=8, vocab=32)


@pytest.fixture(scope="module")
def interleave_setup():
    p = JM.cast_weights(JM.quantize_weights(JM.init_transducer_params(jax.random.PRNGKey(5), IDIMS)),
                        jnp.bfloat16)
    tp = from_jax_params({k: np.asarray(v) for k, v in p.items()})
    rng = np.random.default_rng(6)
    x = rng.normal(size=(IP, IS, IDIMS.d_model)).astype(np.float32)
    h = (rng.normal(size=(IS, IDIMS.d_model)) * 0.3).astype(np.float32)
    c = (rng.normal(size=(IS, IDIMS.hidden)) * 0.3).astype(np.float32)
    n = rng.integers(0, IP + 1, size=IS).astype(np.int32)
    return p, tp, x, h, c, n


@pytest.mark.parametrize("gated", [False, True])
def test_rec_interleave_matches_jax_kernel(interleave_setup, gated):
    jp, tp, x, h, c, n = interleave_setup
    keys = ("w_ih_t_q8", "w_ih_t_q8s", "w_hh_t_q8", "w_hh_t_q8s", "bias", "w_hr_t_q8",
            "w_hr_t_q8s")
    npull = n if gated else np.full(IS, IP, np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = JPCS.rec_interleave_i8(jnp.asarray(x), jnp.asarray(h), jnp.asarray(c),
                                      *(jp[k][0] for k in keys), jnp.asarray(npull),
                                      block_s=IBLOCK)
    got = PCS.rec_interleave_i8(torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(c),
                                *(tp[k][0] for k in keys),
                                torch.from_numpy(n) if gated else None, block_s=512)
    _assert_ulp_close(got[0].numpy(), np.asarray(want[0]), "kernel 22 hseq")
    for g, w, name in zip(got[1:], want[1:], ("h", "c")):
        _assert_stat_close(g.numpy(), np.asarray(w), name=f"kernel 22 {name}")


def test_profile_int8_reports_every_body():
    """The ported tool at its tiny shapes on the CPU: every body at every
    shape, finite times, each checked against its plain version inside the
    tool (`check_body`, the bounds above)."""
    res = PI8.main(["--tiny", "--device", "cpu", "--iters", "1"])
    assert set(res) == {"x".join(map(str, s)) for s in PI8.TINY_SHAPES}
    for shape, bodies in res.items():
        assert set(bodies) == set(PI8.BODIES), shape
        for name, r in bodies.items():
            assert np.isfinite(r["ms"]) and r["max_diff"] == 0, f"{shape} {name}"


_PTXAS = """ptxas info    : Compiling entry function '_Z1kILi2EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z1kILi2EEvPf
ptxas info    : Used {} registers, 380 bytes cmem[0]
"""
_SASS = """	code for sm_90a
		Function : _Z1kILi2EEvPf
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*{:04x}*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                     /* 0x000fe40000000800 */
        /*0010*/                   {} ;                                  /* 0x000000000000794d */
"""


@pytest.mark.parametrize("regs,last,same", [(40, "EXIT", True), (48, "EXIT", True),
                                            (40, "BRA 0x10", False)])
def test_sass_diff_compares_per_kernel(regs, last, same):
    """sass_diff's parsing of ptxas and cuobjdump output: registers per
    kernel, instructions without addresses or encodings."""
    from april_asr_tpu_torch.tools import sass_diff as SD

    old = SD.ptxas_registers(_PTXAS.format(40)), SD.sass_functions(_SASS.format(0, "EXIT"))
    new = SD.ptxas_registers(_PTXAS.format(regs)), SD.sass_functions(_SASS.format(0x20, last))
    assert old[1] == {"_Z1kILi2EEvPf": ["LDC R1, c[0x0][0x28]", "EXIT"]}
    assert SD.compare(old, new, "kILi2") == [
        {"kernel": "_Z1kILi2EEvPf", "regs": (40, regs), "insns": (2, 2), "same": same}]
    assert SD.compare(old, new, "other") == []


def test_matmul_wrappers_refuse_other_devices():
    ins = PI8.make_inputs(32, 64, 48, "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        PI8.mm_i8(ins["xi"].to("meta"), ins["wi"].to("meta"))


# -- the repairs of the port's API ------------------------------------------------


@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    dims = TM.TransducerDims(d_model=16, hidden=16, ffn=16, joiner_dim=16, vocab=32, layers=1,
                             decoder_groups=16, conv_channels=(4, 8, 8))
    path = str(tmp_path_factory.mktemp("tools") / "tiny.april")
    save_april(path, dims, TM.init_transducer_params(9, dims),
               make_model_parameters(dims, default_tokens(dims.vocab)), name="tiny")
    return path


@pytest.mark.parametrize("port,jax_fn", [(Model, JModel), (load_model, j_load_model)],
                         ids=["Model", "load_model"])
def test_signatures_follow_jax(port, jax_fn):
    """The JAX arguments in the JAX order (`path, prefer_native, ...`), the
    port's `device` last."""
    got = list(inspect.signature(port).parameters)
    want = list(inspect.signature(jax_fn).parameters)
    assert got[: len(want)] == want and got[-1] == "device"


def test_model_takes_prefer_native(tiny_model):
    a = Model(tiny_model, True, "int8", device="cpu")
    b = Model(tiny_model, prefer_native=True, device="cpu")
    assert "w_ih_t_q8" in a.runtime.weights and "w_ih_t_q8" not in b.runtime.weights
    assert b.runtime.weights["w_ih_t"].dtype == torch.float32
    assert load_model(tiny_model, False, device="cpu").kind == "native"


def test_init_and_version():
    assert april_asr_tpu_torch.__version__ == april_asr_tpu.__version__
    assert april_asr_tpu_torch.APRIL_VERSION == april_asr_tpu.APRIL_VERSION
    assert {"init", "__version__", "APRIL_VERSION"} <= set(april_asr_tpu_torch.__all__)
    april_asr_tpu_torch.init()
    april_asr_tpu_torch.init(april_asr_tpu_torch.APRIL_VERSION)
    with pytest.raises(ValueError, match="unsupported API version"):
        april_asr_tpu_torch.init(2)


def test_debug_save_audio_matches_jax(tiny_model, tmp_path, monkeypatch):
    """APRIL_DEBUG_SAVE_AUDIO: each package's Session appends the float
    waveform it is fed; the two files are byte for byte equal."""
    pcm = (np.sin(np.arange(1600) * 0.05) * 12000).astype(np.int16)
    files = {}
    for side, model in (("port", Model(tiny_model, device="cpu")), ("jax", JModel(tiny_model))):
        files[side] = tmp_path / f"{side}.f32"
        monkeypatch.setenv("APRIL_DEBUG_SAVE_AUDIO", str(files[side]))
        sess = (Session if side == "port" else JSession)(model, lambda r, t: None)
        sess.feed_pcm16(pcm[:700].tobytes())
        sess.feed_pcm16(pcm[700:])
        sess.close()
    data = files["port"].read_bytes()
    assert data == files["jax"].read_bytes()
    np.testing.assert_array_equal(np.frombuffer(data, np.float32), pcm.astype(np.float32) / 32768.0)


def _run(tok, cells, S=3, n=4):
    """A one-call engine run for `testing.check_parting`: token events
    `tok` [S, n], decision margins `cells` [n, S]."""
    from april_asr_tpu_torch.testing import INT_DECODE

    ev = {"ops": np.zeros((S, 1, n), np.int32), "tok": np.asarray(tok, np.int32).reshape(S, 1, n),
          "flags": np.zeros((S, 1, n), np.int32), "final_k": np.zeros((S, 1, n), np.int32)}
    return {"events": [ev], "cells": [np.asarray(cells, np.float64)], "recs": [[[] for _ in range(S)]],
            "dec": [{k: np.zeros(S, np.int64) for k in INT_DECODE}]}


def test_parting_counts_every_session():
    """`check_parting` raises at a parting decided by NEAR_TIE or more;
    with `over` it lists that session and goes on counting, and the
    parting witness reports both and the largest margin gap of the
    sessions that stayed in step."""
    from april_asr_tpu_torch.testing import NEAR_TIE, check_parting
    from april_asr_tpu_torch.tools.parting_witness import partings, same_events

    cells = [[0.5, 0.2, 0.3], [0.01, 2 * NEAR_TIE, 0.4], [1.0, 1.0, np.inf], [1.0, 1.0, 1.0]]
    a = _run([[1, 2, 3, 4], [1, 2, 3, 4], [1, 2, 3, 4]], cells)
    b = _run([[1, 9, 3, 4], [1, 9, 3, 4], [1, 2, 3, 4]],
             [[0.5, 0.25, 0.2], [0.01, 0.1, 0.45], [1.0, 1.0, np.inf], [1.0, 1.0, 1.0]])
    args = (0, a["events"][0], b["events"][0], a["cells"][0], a["recs"][0], b["recs"][0],
            a["dec"][0], b["dec"][0])
    with pytest.raises(AssertionError, match="session 1 parted at step 0, event cell 1"):
        check_parting(*args, {})
    parted, over = {}, []
    check_parting(*args, parted, over)
    assert parted == {0: (0, 1, 0.01), 1: (0, 1, 2 * NEAR_TIE)} and over == [1]
    parted, over, gap = partings(a, b)
    assert sorted(parted) == [0, 1] and over == [1] and gap == pytest.approx(0.1)
    assert same_events(a, b, 2) and not same_events(a, b, 0)


@pytest.mark.parametrize("precision", ["int8", "bf16", "f32", None])
def test_parting_bound_by_precision(precision):
    """`check_parting` holds two bf16 engines to NEAR_TIE_BF16 (from the
    parting witness on the card) and every other pair to NEAR_TIE: a
    parting at a margin between the two bounds passes at bf16 alone, and
    one at the larger bound fails at every precision."""
    from april_asr_tpu_torch.testing import NEAR_TIE, NEAR_TIE_BF16, check_parting, near_tie

    assert NEAR_TIE < NEAR_TIE_BF16 < 2 * NEAR_TIE
    assert near_tie(precision) == (NEAR_TIE_BF16 if precision == "bf16" else NEAR_TIE)
    between = (NEAR_TIE + NEAR_TIE_BF16) / 2
    for margin, parts in ((NEAR_TIE / 2, True), (between, precision == "bf16"),
                          (NEAR_TIE_BF16, False)):
        cells = [[0.5, 0.5, 0.5], [0.3, margin, 0.4], [1.0, 1.0, 1.0], [1.0, 1.0, 1.0]]
        a = _run([[1, 2, 3, 4]] * 3, cells)
        b = _run([[1, 2, 3, 4], [1, 9, 3, 4], [1, 2, 3, 4]], cells)
        args = (0, a["events"][0], b["events"][0], a["cells"][0], a["recs"][0], b["recs"][0],
                a["dec"][0], b["dec"][0])
        parted, over = {}, []
        check_parting(*args, parted, over, precision=precision)
        assert parted == {1: (0, 1, margin)} and over == ([] if parts else [1])
        if not parts:
            with pytest.raises(AssertionError, match=f">= {near_tie(precision)}"):
                check_parting(*args, {}, precision=precision)
