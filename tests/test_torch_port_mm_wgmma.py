"""Kernel 23 on `wgmma` (csrc/mm_wgmma.cu) without a card: its plan, and
numpy models of the shared-memory layouts its threads write.

- `mm_plan` at the tool's five shapes: tiles that divide the shape, at least
  one tile an SM, the blocks' slices covering each band's N tiles once,
  shared memory within a block's; the ragged 200 x 512 x 4096 refused.
- The int8 B tile: the producer's transform of a raw [128 k][BN] block of w
  (its 4 x 4 byte transposes and lane rotation, as `__byte_perm` computes
  them) must write every byte of the K-major [BN][128] tile once, each
  element (k, n) where the descriptor's 128-byte swizzle reads it.
- dynq's band and the C tile: the kernel's write addresses against the same
  swizzle (the TMA engine's and the descriptor's: address bits 4-6 XOR bits
  7-9 of a 1024-byte-aligned tile).
- dynq's quantization without a division gives the division's codes
  wherever it does not defer to the division.
- The `mma.sync` kernel's names (`*_sync`) take the plain version on the CPU.
"""

import numpy as np
import pytest
import torch

from april_asr_tpu_torch.ops import cuda_build
from april_asr_tpu_torch.tools import profile_int8 as PI8

torch.set_num_threads(1)


def swizzle128(a):
    """The 128-byte swizzle of byte offset a in a 1024-byte-aligned tile."""
    a = np.asarray(a)
    return a ^ (((a >> 7) & 7) << 4)


@pytest.mark.parametrize("shape", PI8.SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", PI8.BODIES)
def test_plan_covers_the_tool_shapes(name, shape):
    M, K, N = shape
    p = PI8.mm_plan(name, M, K, N)
    assert (p.bm, p.bn) in PI8.MW_TILES and M % p.bm == 0 and N % p.bn == 0
    assert K % PI8.MW_KT[name] == 0
    assert p.tiles == (M // p.bm) * (N // p.bn) >= cuda_build.SM_COUNT
    assert p.smem == PI8.mm_smem(name, p.bm, p.bn, p.stages, p.raw, K) <= cuda_build.SMEM_PER_BLOCK
    assert p.stages >= 2 and (p.raw == 0) == (name == "mm_bf16")
    assert p.grid == (M // p.bm) * p.bpb <= cuda_build.SM_COUNT
    ntn = N // p.bn
    slices = [range(j * ntn // p.bpb, (j + 1) * ntn // p.bpb) for j in range(p.bpb)]
    assert all(len(r) for r in slices) and sorted(t for r in slices for t in r) == list(range(ntn))


@pytest.mark.parametrize("name", PI8.BODIES)
def test_plan_refuses_a_ragged_shape(name):
    with pytest.raises(ValueError):
        PI8.mm_plan(name, 200, 512, 4096)
    with pytest.raises(ValueError):
        PI8.mm_plan(name, 256, 96, 256)  # K no k-tile divides


def byte_perm(x, y, s):
    """`__byte_perm(x, y, s)`: result byte i is byte (s >> 4i) & 7 of y:x."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


def transpose4x4_s8(w):
    """csrc/mma_tc.cuh `transpose4x4_s8`."""
    lo01, hi01 = byte_perm(w[0], w[1], 0x5140), byte_perm(w[0], w[1], 0x7362)
    lo23, hi23 = byte_perm(w[2], w[3], 0x5140), byte_perm(w[2], w[3], 0x7362)
    return [byte_perm(lo01, lo23, 0x5410), byte_perm(lo01, lo23, 0x7632),
            byte_perm(hi01, hi23, 0x5410), byte_perm(hi01, hi23, 0x7632)]


def transpose_b(raw, BN, PROD=256):
    """csrc/mm_wgmma.cu `transpose_b` on a raw [128][BN] uint8 block: the
    stage's [BN][128] tile and each byte's write count."""
    flat = raw.reshape(-1)
    word = lambda off: int.from_bytes(flat[off:off + 4].tobytes(), "little")  # noqa: E731
    tile, hits = np.zeros(BN * 128, np.uint8), np.zeros(BN * 128, np.int64)
    for wt in range(PROD):
        for u in range(wt, 2 * BN, PROD):
            ng, kb = u % (BN // 4), u // (BN // 4)
            rho = (ng >> 1) & 3
            rot = sum(((rho + i) & 3) << (4 * i) for i in range(4))
            w = [transpose4x4_s8([byte_perm(word((kb * 16 + q * 4 + r) * BN + ng * 4), 0, rot)
                                  for r in range(4)]) for q in range(4)]
            for j in range(4):
                n = ng * 4 + ((j + rho) & 3)
                off = n * 128 + ((kb ^ (n & 7)) << 4)
                data = b"".join(w[q][j].to_bytes(4, "little") for q in range(4))
                tile[off:off + 16] = np.frombuffer(data, np.uint8)
                hits[off:off + 16] += 1
    return tile, hits


@pytest.mark.parametrize("BN", [128, 64])
def test_int8_b_tile_is_the_descriptors_layout(BN):
    rng = np.random.default_rng(BN)
    raw = rng.integers(0, 256, size=(128, BN), dtype=np.uint8)
    tile, hits = transpose_b(raw, BN)
    assert (hits == 1).all()
    k, n = np.meshgrid(np.arange(128), np.arange(BN), indexing="ij")
    np.testing.assert_array_equal(tile[swizzle128(n * 128 + k)], raw)


def test_int8_b_stores_hit_distinct_columns():
    """Each 8-lane store phase of the transform writes 8 distinct 16-byte
    columns (bank groups) of the 128-byte rows."""
    for BN in (128, 64):
        for j in range(4):
            for lane0 in range(0, 256, 8):
                cols = []
                for u in range(lane0, lane0 + 8):
                    if u >= 2 * BN:
                        continue
                    ng, kb = u % (BN // 4), u // (BN // 4)
                    nn = ng * 4 + ((j + ((ng >> 1) & 3)) & 3)
                    cols.append(kb ^ (nn & 7))
                assert len(set(cols)) == len(cols), (BN, j, lane0)


@pytest.mark.parametrize("BM,K", [(128, 512), (64, 2048)])
def test_dynq_band_and_c_tile_layouts(BM, K):
    # band: unit (m, kc) of 16 k at tile kc // 8, row m, column (kc % 8) ^ (m % 8)
    m, kc = np.meshgrid(np.arange(BM), np.arange(K // 16), indexing="ij")
    got = (kc >> 3) * BM * 128 + m * 128 + (((kc & 7) ^ (m & 7)) << 4)
    want = (kc >> 3) * BM * 128 + swizzle128(m * 128 + (kc & 7) * 16)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == got.size
    # C: f32 (row, col) of a warpgroup's 64 x WN tile, [64][32] boxes
    for WN in (128, 32):
        row, col = np.meshgrid(np.arange(64), np.arange(0, WN, 2), indexing="ij")
        got = (col >> 5) * 8192 + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) + ((col & 3) << 2)
        want = (col >> 5) * 8192 + swizzle128(row * 128 + (col & 31) * 4)
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got)) == got.size


def quant8_model(v, dv):
    """csrc/mm_wgmma.cu `quant8` in float32: (codes, ambiguous)."""
    rc = np.float32(1) / dv
    t = v * rc
    s = t + np.float32(12582912.0)
    n = s - np.float32(12582912.0)
    amb = np.abs(np.abs(t - n) - np.float32(0.5)) < np.float32(2.0**-15)
    code = (s.view(np.uint32) & 0xFF).astype(np.uint8)
    return code, amb


def test_dynq_quantization_without_division_is_exact():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(256, 512)) * rng.uniform(1e-3, 30, size=(256, 1))).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    sx = np.abs(x).max(axis=1, keepdims=True) * np.float32(1 / 127)
    dv = np.maximum(sx.astype(np.float32), np.float32(1e-30))
    # and values at and beside each half-integer multiple of dv
    mid = (np.arange(-127, 127) + np.float32(0.5)).astype(np.float32) * dv[0, 0]
    near = np.stack([mid, np.nextafter(mid, np.float32(-np.inf)),
                     np.nextafter(mid, np.float32(np.inf))])
    for v, d in ((x, dv), (near, dv[0, 0])):
        code, amb = quant8_model(v, d)
        want = np.rint(v / d).astype(np.int64).astype(np.uint8)
        assert ((code == want) | amb).all()
    assert amb.any()


@pytest.mark.parametrize("name", PI8.BODIES)
def test_sync_names_take_the_plain_version_on_cpu(name):
    ins = PI8.make_inputs(64, 128, 64, "cpu", seed=3)
    args = PI8.body_args(name, ins)
    before = dict(cuda_build.COUNTS)
    got = PI8.SYNC[name](*args)
    assert torch.equal(got, PI8.PLAIN[name](*args))
    assert cuda_build.COUNTS == before
