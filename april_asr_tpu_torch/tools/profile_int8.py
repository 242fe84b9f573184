"""Matrix-unit microbenchmark: int8 against bf16 matrix products at the
encoder's shapes, on the card's tensor cores (kernel 23).

Port of tools/profile_int8.py. Its three Pallas bodies become one
hand-written tensor-core GEMM in three forms (csrc/int8_mm.cu, `mma.sync`
from csrc/mma_tc.cuh), with their wrappers and plain versions here, beside
the tool, as the JAX package keeps the bodies in the tool:

    mm_bf16     x bf16 [M, K] @ w bf16 [K, N] -> f32            (`mm_kernel`)
    mm_i8       x int8 @ w int8 -> int32, exact                 (`mm_kernel_i8`)
    mm_i8_dynq  x bf16 quantized per row in the kernel, int8 dot, dequantized
                by sx * s[N] -> f32                             (`mm_kernel_i8_dynq`)

The dynamic quantization follows the tool's op order as XLA compiles it,
which is not `_rowq8`'s: sx = amax / 127, which XLA computes as amax *
f32(1/127) (it rewrites a division by a constant), then q =
round_half_even(x / max(sx, 1e-30)), a true division, and out = (acc * sx)
* s.

Shapes, M x K x N (the tool's `main`): the gate product per session tile and
for the full batch (256 and 2048 x 512 x 4096), the FFN (2048 x 512 x 2048,
2048 x 2048 x 512) and the joiner (2048 x 512 x 512). Inputs from a numpy
seed: x ~ N(0, 1) cast to bf16, int8 values in [-127, 127), column scales
all ones (as the JAX tool has them). Per shape and body it prints the median
device time (CUDA events; on the CPU the host clock), its TF/s or TOP/s, the
library's time on the same shape (cuBLAS through `torch.mm` with f32 output
for bf16, `torch._int_mm` for int8; yardsticks only, the port never calls
them) and the difference from the plain version. No single library call
quantizes, multiplies and dequantizes, so dynq has no library time; its int8
product alone is int8's library time at the same shape.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors (M and N multiples of 128, K of 32 for bf16 and of
64 for the int8 forms; other shapes raise ValueError); it never falls back.

    python -m april_asr_tpu_torch.tools.profile_int8 [--iters 40] [--device cuda] [--tiny]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import cuda_build

SHAPES = ((256, 512, 4096), (2048, 512, 4096), (2048, 512, 2048), (2048, 2048, 512),
          (2048, 512, 512))
TINY_SHAPES = ((32, 64, 48), (48, 128, 40))  # small shapes for a CPU run (--tiny)
TILE_MN = 128
TILE_K = {"mm_bf16": 32, "mm_i8": 64, "mm_i8_dynq": 64}
BODIES = ("mm_bf16", "mm_i8", "mm_i8_dynq")


# -- plain versions -----------------------------------------------------------


def _exact_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in float64: exact for int8 operands (every partial sum of at
    most 2048 products of |v| <= 127 is an integer below 2^53)."""
    return x.double() @ w.double()


def mm_bf16_plain(x, w):
    return x.float() @ w.float()


def mm_i8_plain(x, w):
    return _exact_dot(x, w).to(torch.int32)


def dynq_rows(x):
    """The tool's per-row quantization of x [M, K]: (q integer-valued f32,
    sx [M, 1]); `amax / 127` as XLA computes it, amax * f32(1/127)."""
    xf = x.float()
    sx = xf.abs().amax(dim=-1, keepdim=True) * (1.0 / 127.0)
    return torch.round(xf / torch.clamp_min(sx, 1e-30)), sx


def mm_i8_dynq_plain(x, w, s):
    q, sx = dynq_rows(x)
    return _exact_dot(q, w).float() * sx * s.reshape(1, -1)


PLAIN = {"mm_bf16": mm_bf16_plain, "mm_i8": mm_i8_plain, "mm_i8_dynq": mm_i8_dynq_plain}


# -- the kernels' wrappers ------------------------------------------------------


def _mm_cuda(entry: str, out_dtype, x, w, s=None):
    M, K = x.shape
    N = w.shape[1]
    x_dt = torch.int8 if entry == "mm_i8" else torch.bfloat16
    w_dt = torch.bfloat16 if entry == "mm_bf16" else torch.int8
    for t, dt, shape, what in ((x, x_dt, (M, K), "x"), (w, w_dt, (K, N), "w")):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{entry} {what}: expected a contiguous 16-byte aligned {dt} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if M % TILE_MN or N % TILE_MN or K % TILE_K[entry] or not (M and N and K):
        raise ValueError(f"{entry}: M x K x N = {M} x {K} x {N}; the kernel takes M and N "
                         f"multiples of {TILE_MN} and K a multiple of {TILE_K[entry]}")
    ptrs = [x.data_ptr(), w.data_ptr()]
    if s is not None:
        s = s.reshape(-1)
        if s.dtype != torch.float32 or s.numel() != N or not s.is_contiguous():
            raise ValueError(f"{entry} s: expected contiguous float32 [{N}]")
        ptrs.append(s.data_ptr())
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    fn = cuda_build.bind("int8_mm", entry, len(ptrs) + 1, 3)
    cuda_build.COUNTS[entry] += 1
    rc = fn(*ptrs, out.data_ptr(), M, K, N, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(rc, entry)
    return out


def _route(entry: str, x):
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {x.device}")
    return True


def mm_bf16(x, w):
    """Kernel 23, `mm_kernel`: x bf16 [M, K] @ w bf16 [K, N] -> f32 [M, N]."""
    if not _route("mm_bf16", x):
        return mm_bf16_plain(x, w)
    return _mm_cuda("mm_bf16", torch.float32, x, w)


def mm_i8(x, w):
    """Kernel 23, `mm_kernel_i8`: x int8 [M, K] @ w int8 [K, N] -> int32."""
    if not _route("mm_i8", x):
        return mm_i8_plain(x, w)
    return _mm_cuda("mm_i8", torch.int32, x, w)


def mm_i8_dynq(x, w, s):
    """Kernel 23, `mm_kernel_i8_dynq`: x bf16 [M, K] quantized per row,
    @ w int8 [K, N], dequantized by sx * s (s f32 [1, N]) -> f32 [M, N]."""
    if not _route("mm_i8_dynq", x):
        return mm_i8_dynq_plain(x, w, s)
    return _mm_cuda("mm_i8_dynq", torch.float32, x, w, s)


KERNEL = {"mm_bf16": mm_bf16, "mm_i8": mm_i8, "mm_i8_dynq": mm_i8_dynq}


# the one PyTorch call that computes a body's function on its inputs (cuBLAS
# on the card), timed beside it; dynq has none
LIBRARY = {
    "mm_bf16": lambda ins: torch.mm(ins["x16"], ins["w16"], out_dtype=torch.float32),
    "mm_i8": lambda ins: torch._int_mm(ins["xi"], ins["wi"]),
}


# -- checks ---------------------------------------------------------------------


def check_body(name: str, got, want, args) -> float:
    """Holds a body's output against its plain version on the same inputs and
    returns the max |got - want|. int8: equal element for element. dynq: the
    quantized values and int32 sums are exact, so the outputs agree to 2 f32
    ulps of each value. bf16: the products of bf16 values are exact in f32 and
    only the order of the K-term f32 sums differs, so each output is within
    the worst-case accumulation bound K * 2^-24 * (|x| @ |w|) of the float64
    sum."""
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    if name == "mm_i8":
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: differs from the plain version")
    elif name == "mm_i8_dynq":
        d = (got - want).abs()
        if bool((d > want.abs() * 2.0**-22).any()):
            raise AssertionError(f"{name}: beyond 2 f32 ulps, max {float(d.max()):.3g}")
    else:
        x, w = args
        K = x.shape[1]
        exact = _exact_dot(x, w)
        tol = K * 2.0**-24 * (x.double().abs() @ w.double().abs())
        over = float(((got.double() - exact).abs() - tol).max())
        if over > 0:
            raise AssertionError(f"{name}: beyond K * 2^-24 * (|x| @ |w|) by {over:.3g}")
    return float((got.double() - want.double()).abs().max())


# -- the tool ---------------------------------------------------------------------


def make_inputs(M: int, K: int, N: int, device, seed: int = 0) -> dict:
    """x16, w16 ~ N(0, 1) as bf16; xi, wi int8 in [-127, 127); ws ones [1, N]."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {
        "x16": t(rng.normal(size=(M, K)).astype(np.float32)).to(torch.bfloat16),
        "w16": t(rng.normal(size=(K, N)).astype(np.float32)).to(torch.bfloat16),
        "xi": t(rng.integers(-127, 127, size=(M, K)).astype(np.int8)),
        "wi": t(rng.integers(-127, 127, size=(K, N)).astype(np.int8)),
        "ws": torch.ones((1, N), dtype=torch.float32, device=device),
    }


def body_args(name: str, ins: dict) -> tuple:
    return {"mm_bf16": (ins["x16"], ins["w16"]), "mm_i8": (ins["xi"], ins["wi"]),
            "mm_i8_dynq": (ins["x16"], ins["wi"], ins["ws"])}[name]


def device_ms(fn, iters: int, device, warmup: int = 3) -> float:
    """Median time of one call of `fn`. On the card each call is timed by
    CUDA events behind a device-side sleep, so the host's launch overhead is
    hidden and the events bracket the device work alone; on the CPU, the
    host clock."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_000_000)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def run(M: int, K: int, N: int, device, iters: int = 40) -> dict:
    """Every body at M x K x N: {body: {"ms", "rate", "library_ms",
    "max_diff"}}; rates in TF/s (bf16) or TOP/s (int8) of 2MKN operations,
    and with the library's time on the card only (None on the CPU, and for
    dynq, which no one library call computes)."""
    ins = make_inputs(M, K, N, device)
    where = (f"{torch.cuda.get_device_name(device)}, CUDA events" if device.type == "cuda"
             else "cpu, host clock")
    ops = 2.0 * M * K * N
    out = {}
    for name in BODIES:
        args = body_args(name, ins)
        got, want = KERNEL[name](*args), PLAIN[name](*args)
        diff = check_body(name, got, want, args)
        ms = device_ms(lambda: KERNEL[name](*args), iters, device)
        lib = (device_ms(lambda: LIBRARY[name](ins), iters, device)
               if device.type == "cuda" and name in LIBRARY else None)
        rate = ops / (ms * 1e-3) / 1e12 if device.type == "cuda" else None
        out[name] = {"ms": ms, "rate": rate, "library_ms": lib, "max_diff": diff}
        unit = "TF/s" if name == "mm_bf16" else "TOP/s"
        rate_s = f"{rate:.1f} {unit}" if rate is not None else f"{unit} not measured"
        lib_s = (f"{lib * 1e3:.1f} us" if lib is not None else "none" if name not in LIBRARY
                 else "not measured")
        print(f"[{M}x{K}x{N}] {name}: {ms * 1e3:.1f} us ({rate_s}); library {lib_s}; "
              f"max diff vs plain {diff:.3g} ({where})")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help=f"small shapes for the CPU: {TINY_SHAPES}")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    return {f"{M}x{K}x{N}": run(M, K, N, dev, args.iters)
            for M, K, N in (TINY_SHAPES if args.tiny else SHAPES)}


if __name__ == "__main__":
    main()
