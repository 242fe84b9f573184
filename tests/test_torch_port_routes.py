"""Port: the width repairs — models that the JAX package serves and the
port used to refuse.

* The top package exports every name of the JAX package's `__all__` that
  the port defines (`MeshConfig` was missing).
* int8: where kernels 2 and 7 keep no stationary plan, their calls take
  kernel 14 (csrc/lstm_hoist.cu, on its `rec_hoist_plan`; its CUDA-core
  template only where that has none) and the three-pass step
  (ops/lstm_mma.py `int8_routes`); kernel
  3 (`ffn_plan`, tiled tensor-core passes) has no width limit: every
  128-multiple model up to d 1024, H 4096 and F 8192 has a route at S = 1,
  3, 256 and 2048, and the flagship widths keep kernels 2 and 7.
* `build_engine` on a CUDA runtime plans every layer kernel of its step and
  flush before it serves (`check_kernel_plans`); a model whose widths are
  not multiples of 4 (which the JAX package serves through XLA) is planned
  and served on the same kernels at its widths zero-padded to multiples of
  4 (ops/widths.py), and so is the tensor-parallel engine at such shard
  widths: the check plans its kernels by their routes at the padded shard
  widths, and refuses only where no route has a launch, with the kernel and
  the widths named.
"""

import dataclasses
import re

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
from april_asr_tpu_torch.ops import tp_plan as TP
from april_asr_tpu_torch.ops.lstm_tp_kernels import tp_smem
from april_asr_tpu_torch.parallel.mesh import TPMesh
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
        plan = LM.ffn_plan(P * S, d, F)
        assert plan.smem <= LM.SMEM_LIMIT and plan.grid(F)[1] * LM.FFN_TILE == plan.rp
        if r.rec == "stream":
            # kernel 14 on its own plan; its template's block would fit too
            assert LM.rec_hoist_plan(S, d, H).smem <= LM.SMEM_LIMIT
            assert LM.rec_stream_smem(d, H) <= LM.SMEM_LIMIT
        if r.step == "simt":
            assert LM.step_simt_smem(d, H, F) <= LM.SMEM_LIMIT
        seen.add((r.rec, r.step))
    # the grid reaches every route
    assert {r for r, _ in seen} == {"mma", "stream"}
    assert {s for _, s in seen} == {"mma", "simt"}


@pytest.mark.parametrize("S", [1, 3, 256, 2048])
def test_int8_routes_keep_the_flagship_kernels(S):
    assert LM.int8_routes(S, 27, 512, 1024, 2048) == LM.Int8Routes("mma", "mma")
    assert LM.int8_routes(S, 27, 1024, 4096, 8192) == LM.Int8Routes("stream", "simt")


def test_int8_route_bytes():
    """The C launches' byte counts at the widest F1 model: kernel 14's
    phase-B block (a 32-unit item's w_hh slice, a one-tile projection item,
    the A ring) beside its CUDA-core template's block of 4 sessions, the
    int8 three-pass step's 4-row FFN tile; kernel 3's
    block (two stages of 128 x 80-byte A and B tiles and 128 amax slots) at
    every width, where the CUDA-core kernel 3 it replaced staged a [16][F]
    mid tile (204,928 bytes at the flagship, none fitting past d 512 / F
    2432 at 16 rows, d 4096 / F 16384 at any)."""
    assert LM.rec_stream_smem(1024, 4096) == 204_864
    for S in (1, 3, 256, 2048):
        assert LM.rec_hoist_plan(S, 1024, 4096).smem == 222_368 <= LM.SMEM_LIMIT
        assert LM.hoist_route(S, 1024, 4096) == "hoist"
    # kernel 14's template takes kernel 2's call only where neither plan
    # fits: 136 32-unit gate items at H 4352 outnumber the SMs
    assert LM.rec_route(256, 128, 4352) == "stream_simt"
    assert LM.rec_stream_smem(128, 4352) == 163_904
    with pytest.raises(ValueError, match="its template needs 323648 bytes"):
        LM.rec_route(256, 512, 8192)
    assert LM.step_simt_smem(1024, 4096, 8192) == LM.ffn_i8_smem(4, 1024, 8192) == 184_352
    assert LM.FFN_SMEM == 2 * 2 * 128 * 80 + 512 == 41_472
    assert LM.ffn_i8_smem(16, 512, 2048) == 204_928
    assert LM.ffn_i8_smem(16, 512, 2432) > LM.SMEM_LIMIT
    assert LM.ffn_plan(6912, 512, 2432).smem == LM.ffn_plan(6912, 4096, 16384).smem == LM.FFN_SMEM
    with pytest.raises(ValueError, match="multiples of 4"):
        LM.ffn_plan(6912, 510, 2048)


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


TP_KIND = {18: "gcp", 19: "gc_i8", 20: "ffn", 21: "mid_i8"}


@pytest.mark.parametrize("precision, kernel", [
    (None, "f32 tensor-parallel kernels \\(18, 20\\)"),
    ("bf16", "bf16 tensor-parallel kernels \\(18, 20\\)"),
    ("int8", "int8 tensor-parallel kernels \\(19, 21\\)"),
])
def test_build_engine_refuses_at_load(precision, kernel, monkeypatch):
    """A CUDA runtime at d = 66 / H 130 / F 198 is served: its engine builds
    with every layer kernel planned at the widths padded to multiples of 4
    (68, 132, 200), and so is its tensor-parallel engine at m = 2: the check
    routes `kernel` at the shard's widths padded likewise (d 68, H/m 65 ->
    68, F/m 99 -> 100), each to its one-launch kernel (the check reads shapes
    only, so a CPU runtime stands in, its device set to CUDA and the SM
    count to the H100's). The CPU engine at m = 2 builds at these widths
    too (tests/test_torch_port_tp.py runs the TP stack there)."""
    rt = dataclasses.replace(_runtime(66, 130, 198, precision, layers=2),
                             device=torch.device("cuda"))
    monkeypatch.setattr(LM, "device_sm", lambda dev: 132)
    planned = []
    for name in ("int8_routes", "float_step_plan", "float_chunk_plan"):
        fn = getattr(LM, name)
        monkeypatch.setattr(LM, name, lambda *a, fn=fn: planned.append(a) or fn(*a))
    ES.build_engine(rt, 4)
    assert len(planned) == (1 if precision == "int8" else 2)
    assert all(any(a[i:i + 3] == (68, 132, 200) for i in range(len(a))) for a in planned)
    routed, route = [], TP.tp_route
    monkeypatch.setattr(TP, "tp_route", lambda *a: routed.append(a) or route(*a))
    ES.check_kernel_plans(rt, 4, 27, n_sm=132, m=2)
    ks = [int(k) for k in re.search(r"\((\d+), (\d+)\)", kernel.replace("\\", "")).groups()]
    assert routed == [(TP_KIND[k], 4, 68, 68 if k < 20 else 100, 132) for k in ks]
    assert all(route(*a) == "fused" for a in routed)
    cpu = _runtime(66, 130, 198, precision, layers=2)
    assert ES.build_engine(cpu, 4, mesh=TPMesh(None, 0, 2)).tp_axes == ("model",)


def test_tp_plans_follow_the_shard_widths(monkeypatch):
    """The column-pass kernels that 18 and 20 replaced staged f32 activation
    rows, so at d 1024 their gate pass does not fit a block; kernels 18 and
    20 stream their rows through rings that do not grow with d, so a TP
    engine at f32 and d 1024 is planned on them. Where a one-launch kernel
    has no plan, the check takes its column-pass kernel's shared memory: at
    d 1024 kernel 18's does not fit (refused, kernel and widths named),
    kernel 20's does (served). Kernels 19 and 21 stage int8 rows and fit
    even at d 1024 / Hs 2048 / Fs 4096."""
    assert max(tp_smem(512, 512, 1024, 4).values()) <= LM.SMEM_LIMIT
    assert tp_smem(1024, 512, 1024, 4)["gates"] > LM.SMEM_LIMIT
    assert max(tp_smem(1024, 2048, 4096, 1).values()) <= LM.SMEM_LIMIT
    rt = _runtime(1024, 256, 512, None)
    assert TP.tp_route("gcp", 4, 1024, 128) == TP.tp_route("ffn", 4, 1024, 256) == "fused"
    ES.check_kernel_plans(rt, 4, 27, n_sm=132, m=2)
    monkeypatch.setitem(TP.PLANS, "ffn", lambda *a, **kw: None)
    ES.check_kernel_plans(rt, 4, 27, n_sm=132, m=2)
    monkeypatch.setitem(TP.PLANS, "gcp", lambda *a, **kw: None)
    with pytest.raises(ValueError, match="f32 tensor-parallel kernel 18 has no launch for "
                                         "d_model=1024, hidden=256, ffn=512.*gates"):
        ES.check_kernel_plans(rt, 4, 27, n_sm=132, m=2)
    ES.check_kernel_plans(_runtime(128, 256, 512, "int8"), 4, 27, n_sm=132, m=2)
    np.testing.assert_equal(tp_smem(512, 512, 1024, 1)["gates"], 256 + 64 * 528 + 16384)
