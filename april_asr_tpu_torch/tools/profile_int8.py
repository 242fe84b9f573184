"""Matrix-unit microbenchmark: int8 against bf16 matrix products at the
encoder's shapes, on the card's tensor cores (kernel 23).

Port of tools/profile_int8.py. Its three Pallas bodies become one
hand-written persistent GEMM in three forms (csrc/mm_wgmma.cu: `wgmma` on
operands the TMA engine brings, a producer warpgroup, TMA stores under the
next tile's products; the PTX pieces in csrc/wgmma.cuh), with their
wrappers and plain versions here, beside the tool, as the JAX package keeps
the bodies in the tool:

    mm_bf16     x bf16 [M, K] @ w bf16 [K, N] -> f32            (`mm_kernel`)
    mm_i8       x int8 @ w int8 -> int32, exact                 (`mm_kernel_i8`)
    mm_i8_dynq  x bf16 quantized per row in the kernel, int8 dot, dequantized
                by sx * s[N] -> f32                             (`mm_kernel_i8_dynq`)

The dynamic quantization follows the tool's op order as XLA compiles it,
which is not `_rowq8`'s: sx = amax / 127, which XLA computes as amax *
f32(1/127) (it rewrites a division by a constant), then q =
round_half_even(x / max(sx, 1e-30)), a true division, and out = (acc * sx)
* s.

`mm_plan` picks the kernel's tile (128 x 128 where those tiles fill a wave
of the card's SMs, else 64 x 64), its stages and its shared-memory bytes,
which the kernel checks against its own layout. The `mma.sync` kernel it
replaced (csrc/int8_mm.cu: 128 x 128 tiles, one k-tile in flight) stays as
`mm_bf16_sync`, `mm_i8_sync` and `mm_i8_dynq_sync`, counted apart, the
comparison on the card; the tool never launches it.

Shapes, M x K x N (the tool's `main`): the gate product per session tile and
for the full batch (256 and 2048 x 512 x 4096), the FFN (2048 x 512 x 2048,
2048 x 2048 x 512) and the joiner (2048 x 512 x 512). Inputs from a numpy
seed: x ~ N(0, 1) cast to bf16, int8 values in [-127, 127), column scales
all ones (as the JAX tool has them). Per shape it prints each body's plan,
and per body the median device time (CUDA events; on the CPU the host
clock), its TF/s or TOP/s, the library's time on the same shape (cuBLAS
through `torch.mm` with f32 output for bf16, `torch._int_mm` for int8;
yardsticks only, the port never calls them) and the difference from the
plain version. No single library call quantizes, multiplies and
dequantizes, so dynq has no library time; its int8 product alone is int8's
library time at the same shape.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors (shapes `mm_plan` refuses, and for the `*_sync`
kernel M and N not multiples of 128 or K not of 32 (bf16) or 64 (int8
forms), raise ValueError); it never falls back.

    python -m april_asr_tpu_torch.tools.profile_int8 [--iters 40] [--device cuda] [--tiny] [--clock]

With --clock, each body's phase clock at each shape (`profile`: the
kernel's span and, per block, its prologue, waits, transforms and
epilogues from the global nanosecond timer).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import cuda_build

SHAPES = ((256, 512, 4096), (2048, 512, 4096), (2048, 512, 2048), (2048, 2048, 512),
          (2048, 512, 512))
TINY_SHAPES = ((32, 64, 48), (48, 128, 40))  # small shapes for a CPU run (--tiny)
BODIES = ("mm_bf16", "mm_i8", "mm_i8_dynq")
# the `mma.sync` kernel's tiles (csrc/int8_mm.cu)
TILE_MN = 128
TILE_K = {"mm_bf16": 32, "mm_i8": 64, "mm_i8_dynq": 64}


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


# -- the plan -------------------------------------------------------------------

MW_ROW = 128  # bytes of a k-tile row in csrc/mm_wgmma.cu: 64 bf16 or 128 int8
MW_KT = {"mm_bf16": 64, "mm_i8": 128, "mm_i8_dynq": 128}  # k a stage
MW_TILES = ((128, 128), (64, 64))  # the kernel's instantiations, BM x BN
MW_MAX_STAGES = 6  # bf16's ring
MW_I8_STAGES = 3  # the int8 forms' ring: their producer's transposes, not loads, bind it
MW_MAX_RAW = 8  # the int8 forms' raw ring of w's blocks, as deep as fits


@dataclasses.dataclass(frozen=True)
class MmPlan:
    bm: int
    bn: int
    stages: int  # the ring of A and B tiles the consumers read
    raw: int  # the int8 forms' raw ring of w blocks, 0 for bf16
    smem: int  # bytes, as csrc/mm_wgmma.cu `mw_smem` counts them
    tiles: int
    bpb: int  # blocks a band: each walks a slice of one M band's N tiles
    grid: int  # M / bm bands x bpb, at most one block an SM where bands allow

    def __str__(self):
        return (f"{self.bm}x{self.bn} tiles ({self.tiles}; {self.grid} blocks, {self.bpb} a band), "
                f"{self.stages} stages, {self.raw} raw, {self.smem} B of shared memory")


def mm_smem(name: str, bm: int, bn: int, stages: int, raw: int, K: int) -> int:
    """csrc/mm_wgmma.cu `mw_smem`: 1024 bytes to align the base, the ring
    (B [bn][128 B] a stage, and but for dynq A [bm][128 B]), the raw ring of
    w's [128 k][bn] bytes (int8 forms), the two consumer warpgroups' f32 or
    int32 C tiles, dynq's resident int8 band [bm][K] and its [bm] row
    scales, and the mbarriers (full and empty a stage, and a raw stage)."""
    stage = MW_ROW * (bn + (0 if name == "mm_i8_dynq" else bm))
    raw_b = 0 if name == "mm_bf16" else MW_ROW * bn
    band = bm * K + 4 * bm if name == "mm_i8_dynq" else 0
    return 1024 + stages * stage + raw * raw_b + 4 * bm * bn + band + 8 * (2 * stages + 2 * raw)


def mm_plan(name: str, M: int, K: int, N: int, sms: int = cuda_build.SM_COUNT) -> MmPlan:
    """Kernel 23's plan on a card of `sms` SMs. The tile: of those that
    divide M x N (128 x 128, 64 x 64), the largest that gives at least one
    tile an SM, else the smallest (more tiles than SMs at every shape of the
    tool), the first whose two stages fit a block. The depths: bf16 as many
    ring stages as the block's shared memory holds (2 to 6); the int8 forms
    3 ring stages (else 2) and as many raw stages as fit (2 to 8). The grid: bpb = min(N tiles, SMs // bands) blocks a band (at
    least 1), each a contiguous slice of the band's N tiles. ValueError where
    no tile divides M x N or fits, or the k-tile does not divide K."""
    if name not in MW_KT:
        raise ValueError(f"mm_plan: unknown body {name}")
    if K <= 0 or K % MW_KT[name]:
        raise ValueError(f"{name}: K = {K}; csrc/mm_wgmma.cu takes K a multiple of {MW_KT[name]}")
    fits = [(bm, bn) for bm, bn in MW_TILES if M > 0 and N > 0 and M % bm == 0 and N % bn == 0]
    if not fits:
        raise ValueError(f"{name}: M x N = {M} x {N}; csrc/mm_wgmma.cu takes M and N multiples "
                         f"of 128, or of 64")
    full = [t for t in fits if (M // t[0]) * (N // t[1]) >= sms]
    if name == "mm_bf16":
        depths = [(s, 0) for s in range(MW_MAX_STAGES, 1, -1)]
    else:
        depths = [(s, r) for s in (MW_I8_STAGES, 2) for r in range(MW_MAX_RAW, 1, -1)]
    for bm, bn in full + [t for t in reversed(fits) if t not in full]:
        fit = [(s, r) for s, r in depths
               if mm_smem(name, bm, bn, s, r, K) <= cuda_build.SMEM_PER_BLOCK]
        if fit:
            stages, raw = fit[0]
            break
    else:
        raise ValueError(f"{name}: no two stages of any tile fit one block at K = {K}")
    bands, ntn = M // bm, N // bn
    bpb = max(1, min(ntn, sms // bands))
    return MmPlan(bm, bn, stages, raw, mm_smem(name, bm, bn, stages, raw, K), bands * ntn, bpb,
                  bands * bpb)


def plan_line(name: str, M: int, K: int, N: int, sms: int = cuda_build.SM_COUNT) -> str:
    try:
        return f"{name} {mm_plan(name, M, K, N, sms)}"
    except ValueError as e:
        return f"{name} no plan ({e})"


# -- the kernels' wrappers ------------------------------------------------------


def _operands(entry: str, x, w, s):
    """The checks both kernels' entries make; (M, K, N, pointers)."""
    M, K = x.shape
    N = w.shape[1]
    x_dt = torch.int8 if entry.startswith("mm_i8") and "dynq" not in entry else torch.bfloat16
    w_dt = torch.bfloat16 if entry.startswith("mm_bf16") else torch.int8
    for t, dt, shape, what in ((x, x_dt, (M, K), "x"), (w, w_dt, (K, N), "w")):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{entry} {what}: expected a contiguous 16-byte aligned {dt} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    ptrs = [x.data_ptr(), w.data_ptr()]
    if s is not None:
        s = s.reshape(-1)
        if s.dtype != torch.float32 or s.numel() != N or not s.is_contiguous() or s.data_ptr() % 16:
            raise ValueError(f"{entry} s: expected contiguous 16-byte aligned float32 [{N}]")
        ptrs.append(s.data_ptr())
    return M, K, N, ptrs


MW_ENTRY = {"mm_bf16": "mm_wgmma_bf16", "mm_i8": "mm_wgmma_i8", "mm_i8_dynq": "mm_wgmma_dynq"}


def _mm_wgmma(name: str, out_dtype, x, w, s=None, plan: MmPlan = None, stamps=None):
    """csrc/mm_wgmma.cu on `plan` (default `mm_plan`'s; count `name`);
    `stamps` an int64 [grid, MW_NSTAMP] buffer for the phase clock."""
    M, K, N, ptrs = _operands(name, x, w, s)
    if plan is None:
        plan = mm_plan(name, M, K, N,
                       torch.cuda.get_device_properties(x.device).multi_processor_count)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    fn = cuda_build.bind("mm_wgmma", MW_ENTRY[name], len(ptrs) + 2, 9)
    rc = fn(*ptrs, out.data_ptr(), 0 if stamps is None else stamps.data_ptr(), M, K, N, plan.bm,
            plan.bn, plan.stages, plan.raw, plan.smem, plan.bpb,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc < 0:
        raise RuntimeError(f"{name}: the plan's {plan.smem} bytes of shared memory are not the "
                           f"kernel's {-rc} ({plan})")
    cuda_build.check(rc, name)
    cuda_build.COUNTS[name] += 1
    return out


def _mm_sync(entry: str, out_dtype, x, w, s=None):
    """csrc/int8_mm.cu, the `mma.sync` kernel (count `<entry>_sync`)."""
    M, K, N, ptrs = _operands(entry, x, w, s)
    if M % TILE_MN or N % TILE_MN or K % TILE_K[entry] or not (M and N and K):
        raise ValueError(f"{entry}_sync: M x K x N = {M} x {K} x {N}; the kernel takes M and N "
                         f"multiples of {TILE_MN} and K a multiple of {TILE_K[entry]}")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    fn = cuda_build.bind("int8_mm", entry, len(ptrs) + 1, 3)
    cuda_build.COUNTS[f"{entry}_sync"] += 1
    rc = fn(*ptrs, out.data_ptr(), M, K, N, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(rc, f"{entry}_sync")
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
    return _mm_wgmma("mm_bf16", torch.float32, x, w)


def mm_i8(x, w):
    """Kernel 23, `mm_kernel_i8`: x int8 [M, K] @ w int8 [K, N] -> int32."""
    if not _route("mm_i8", x):
        return mm_i8_plain(x, w)
    return _mm_wgmma("mm_i8", torch.int32, x, w)


def mm_i8_dynq(x, w, s):
    """Kernel 23, `mm_kernel_i8_dynq`: x bf16 [M, K] quantized per row,
    @ w int8 [K, N], dequantized by sx * s (s f32 [1, N]) -> f32 [M, N]."""
    if not _route("mm_i8_dynq", x):
        return mm_i8_dynq_plain(x, w, s)
    return _mm_wgmma("mm_i8_dynq", torch.float32, x, w, s)


def mm_bf16_sync(x, w):
    """`mm_bf16` on the `mma.sync` kernel it replaced (csrc/int8_mm.cu)."""
    if not _route("mm_bf16_sync", x):
        return mm_bf16_plain(x, w)
    return _mm_sync("mm_bf16", torch.float32, x, w)


def mm_i8_sync(x, w):
    """`mm_i8` on the `mma.sync` kernel it replaced (csrc/int8_mm.cu)."""
    if not _route("mm_i8_sync", x):
        return mm_i8_plain(x, w)
    return _mm_sync("mm_i8", torch.int32, x, w)


def mm_i8_dynq_sync(x, w, s):
    """`mm_i8_dynq` on the `mma.sync` kernel it replaced (csrc/int8_mm.cu)."""
    if not _route("mm_i8_dynq_sync", x):
        return mm_i8_dynq_plain(x, w, s)
    return _mm_sync("mm_i8_dynq", torch.float32, x, w, s)


KERNEL = {"mm_bf16": mm_bf16, "mm_i8": mm_i8, "mm_i8_dynq": mm_i8_dynq}
SYNC = {"mm_bf16": mm_bf16_sync, "mm_i8": mm_i8_sync, "mm_i8_dynq": mm_i8_dynq_sync}


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


# -- where the time goes ---------------------------------------------------------

OUT_DTYPE = {"mm_bf16": torch.float32, "mm_i8": torch.int32, "mm_i8_dynq": torch.float32}
MW_NSTAMP = 8  # csrc/mm_wgmma.cu's phase clock slots a block
# the clock's summed slots (ns): consumer warpgroup 0's waits on `full` and
# its epilogues; the producer's waits on raw stages and on `empty`, and its
# transforms (fences and barrier included)
CLOCK = {"full_wait": 2, "epilogue": 3, "raw_wait": 4, "empty_wait": 5, "transform": 6}


def profile(name: str, M: int, K: int, N: int, device, plan: MmPlan = None) -> dict:
    """One call of csrc/mm_wgmma.cu with its phase clock (the global
    nanosecond timer, read by each role around its waits and phases): the
    launch's span (first block's start to last block's end), and per block
    the prologue (dynq's band quantization), the block's time and each
    summed phase of `CLOCK`, as the blocks' median and maximum, in us."""
    ins = make_inputs(M, K, N, device)
    x, w, *s = body_args(name, ins)
    plan = plan or mm_plan(name, M, K, N,
                           torch.cuda.get_device_properties(device).multi_processor_count)
    stamps = torch.zeros((plan.grid, MW_NSTAMP), dtype=torch.int64, device=device)
    _mm_wgmma(name, OUT_DTYPE[name], x, w, *s, plan=plan, stamps=stamps)
    torch.cuda.synchronize(device)
    st = stamps.double().cpu()
    med = lambda v: (float(v.median()) / 1e3, float(v.max()) / 1e3)  # noqa: E731
    out = {"plan": str(plan), "span_us": float(st[:, 7].max() - st[:, 0].min()) / 1e3,
           "prologue_us": med(st[:, 1] - st[:, 0]), "block_us": med(st[:, 7] - st[:, 0])}
    out.update({f"{k}_us": med(st[:, i]) for k, i in CLOCK.items()})
    return out


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
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else cuda_build.SM_COUNT)
    print(f"[{M}x{K}x{N}] plans: " + "; ".join(plan_line(n, M, K, N, sms) for n in BODIES))
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
    ap.add_argument("--clock", action="store_true",
                    help="also each body's phase clock (`profile`; needs the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    out = {}
    for M, K, N in TINY_SHAPES if args.tiny else SHAPES:
        out[f"{M}x{K}x{N}"] = run(M, K, N, dev, args.iters)
        for name in BODIES if args.clock else ():
            r = profile(name, M, K, N, dev)
            print(f"[{M}x{K}x{N}] {name} clock ({r.pop('plan')}): " + "; ".join(
                f"{k} {v:.1f}" if isinstance(v, float) else f"{k} {v[0]:.1f} (max {v[1]:.1f})"
                for k, v in r.items()))
    return out


if __name__ == "__main__":
    main()
