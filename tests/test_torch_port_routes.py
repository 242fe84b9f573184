"""Port: the width repairs — models that the JAX package serves and the
port used to refuse.

* The top package exports every name of the JAX package's `__all__` that
  the port defines (`MeshConfig` was missing).
* int8: where kernels 2 and 7 keep no stationary plan, their calls take
  kernel 14 and the three-pass step, and kernel 3 a smaller row tile
  (ops/lstm_mma.py `int8_routes`): every 128-multiple model up to d 1024,
  H 4096 and F 8192 has a route at S = 1, 3, 256 and 2048, and the flagship
  widths keep kernels 2, 7 and 3 at 16 rows.
* `build_engine` on a CUDA runtime plans every layer kernel of its step and
  flush before it serves (`check_kernel_plans`), and refuses widths that
  are not multiples of 4 with the widths and the kernel named.
"""

import dataclasses

import numpy as np
import pytest
import torch

import april_asr_tpu as J
import april_asr_tpu_torch as T
from april_asr_tpu_torch.api.model import apply_precision
from april_asr_tpu_torch.engine import step as ES
from april_asr_tpu_torch.models.export import make_model_parameters
from april_asr_tpu_torch.models.loader import native_runtime
from april_asr_tpu_torch.models.lstm_transducer import TransducerDims, init_transducer_params
from april_asr_tpu_torch.ops import lstm_mma as LM
from april_asr_tpu_torch.ops.lstm_tp_kernels import tp_smem
from april_asr_tpu_torch.testing import default_tokens


def test_top_package_exports_the_jax_names_it_defines():
    shared = [n for n in J.__all__ if hasattr(T, n)]
    assert "MeshConfig" in shared and T.MeshConfig().model_axis == J.MeshConfig().model_axis
    assert [n for n in shared if n not in T.__all__] == []


def _f1_widths():
    """128-multiple (d, H, F) up to d 1024, H 4096, F in {d, 2d, 2H} <= 8192."""
    for d in range(128, 1025, 128):
        for H in range(128, 4097, 128):
            for F in sorted({d, 2 * d, 2 * H}):
                if F <= 8192:
                    yield d, H, F


@pytest.mark.parametrize("P", [1, 27, 56])
@pytest.mark.parametrize("S", [1, 3, 256, 2048])
def test_int8_routes_serve_every_f1_width(S, P):
    seen = set()
    for d, H, F in _f1_widths():
        r = LM.int8_routes(S, P, d, H, F)
        assert r.rec in ("mma", "stream") and r.step in ("mma", "simt")
        assert LM.ffn_i8_smem(r.ffn_rows, d, F) <= LM.SMEM_LIMIT
        if r.rec == "stream":
            assert LM.rec_stream_smem(d, H) <= LM.SMEM_LIMIT
        if r.step == "simt":
            assert LM.step_simt_smem(d, H, F) <= LM.SMEM_LIMIT
        seen.add((r.rec, r.step, r.ffn_rows))
    # the grid reaches every route
    assert {r for r, _, _ in seen} == {"mma", "stream"}
    assert {s for _, s, _ in seen} == {"mma", "simt"}
    assert {k for _, _, k in seen} == set(LM.FFN_ROWS)


@pytest.mark.parametrize("S", [1, 3, 256, 2048])
def test_int8_routes_keep_the_flagship_kernels(S):
    assert LM.int8_routes(S, 27, 512, 1024, 2048) == LM.Int8Routes("mma", "mma", 16)
    assert LM.int8_routes(S, 27, 1024, 4096, 8192) == LM.Int8Routes("stream", "simt", 4)


def test_int8_route_bytes():
    """The C launches' byte counts at the widest F1 model: kernel 14's block
    of 4 sessions, the int8 three-pass step's 4-row FFN tile, kernel 3's
    16-, 8- and 4-row tiles."""
    assert LM.rec_stream_smem(1024, 4096) == 204_864
    assert LM.step_simt_smem(1024, 4096, 8192) == LM.ffn_i8_smem(4, 1024, 8192) == 184_352
    assert [LM.ffn_i8_smem(r, 512, 2048) for r in LM.FFN_ROWS] == [204_928, 102_464, 51_232]
    assert LM.ffn_rows(512, 2432) == 8 and LM.ffn_rows(512, 2048) == 16
    with pytest.raises(ValueError, match="no row tile"):
        LM.ffn_rows(4096, 16384)


def _runtime(d, H, F, precision=None, layers=1):
    dims = TransducerDims(d_model=d, hidden=H, ffn=F, joiner_dim=64, vocab=32, layers=layers,
                          decoder_groups=2, conv_channels=(4, 8, 8))
    p = init_transducer_params(0, dims)
    mp = make_model_parameters(dims, default_tokens(dims.vocab))
    return native_runtime("t", "", "en-us", mp, dims, apply_precision(p, precision), "cpu")


@pytest.mark.parametrize("precision", [None, "bf16", "int8"])
def test_plans_take_multiples_of_4(precision):
    """d = 68, H = 260, F = 196 (multiples of 4, not of 8) plan every layer
    kernel of the step and flush at S = 1, 256 and P = 27."""
    rt = _runtime(68, 260, 196, precision)
    for S in (1, 256):
        ES.check_kernel_plans(rt, S, 27, n_sm=132)


@pytest.mark.parametrize("precision, kernel", [(None, "kernel 12 \\(f32\\)"),
                                               ("bf16", "kernel 12 \\(bf16\\)"),
                                               ("int8", "int8")])
def test_build_engine_refuses_at_load(precision, kernel, monkeypatch):
    """A CUDA runtime at d = 66 is refused when its engine is built, with
    the widths and the kernel in the message (the check reads shapes only,
    so a CPU runtime stands in, its device set to CUDA and the SM count to
    the H100's)."""
    rt = dataclasses.replace(_runtime(66, 132, 264, precision), device=torch.device("cuda"))
    monkeypatch.setattr(LM, "device_sm", lambda dev: 132)
    with pytest.raises(ValueError, match=f"{kernel}.*d_model=66, hidden=132, ffn=264"):
        ES.build_engine(rt, 4)


def test_tp_plans_follow_the_shard_widths():
    """Kernels 18 and 20 stage f32 activation rows: at d 1024 their gate
    pass does not fit a block, so a TP engine at f32 is refused; kernels 19
    and 21 stage int8 rows and fit even at d 1024 / Hs 2048 / Fs 4096."""
    assert max(tp_smem(512, 512, 1024, 4).values()) <= LM.SMEM_LIMIT
    assert tp_smem(1024, 512, 1024, 4)["gates"] > LM.SMEM_LIMIT
    assert max(tp_smem(1024, 2048, 4096, 1).values()) <= LM.SMEM_LIMIT
    rt = _runtime(1024, 256, 512, None)
    with pytest.raises(ValueError, match="tensor-parallel kernels \\(18, 20\\)"):
        ES.check_kernel_plans(rt, 4, 27, n_sm=132, m=2)
    ES.check_kernel_plans(_runtime(128, 256, 512, "int8"), 4, 27, n_sm=132, m=2)
    np.testing.assert_equal(tp_smem(512, 512, 1024, 1)["gates"], 256 + 64 * 528 + 16384)
