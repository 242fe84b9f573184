// Kernel 23 for the H100: the matrix-unit microbenchmark of
// tools/profile_int8.py -- one [M, K] x [K, N] product in three forms -- as
// one persistent, warp-specialised kernel on `wgmma` and the TMA engine.
//
// Replaces tools/profile_int8.py `call` (the ungridded `pl.pallas_call`) over
// its bodies, as csrc/int8_mm.cu did before it (kept as the `*_sync`
// entries, the comparison; the tool's route never launches it):
//   mm_bf16     `mm_kernel`: x bf16 [M, K] @ w bf16 [K, N] -> f32
//   mm_i8       `mm_kernel_i8`: int8 x int8 -> int32, exact
//   mm_i8_dynq  `mm_kernel_i8_dynq`: x bf16 quantized per row in the kernel
//               (sx = amax * f32(1/127), q = round_half_even(x / max(sx,
//               1e-30)), an IEEE division), the int8 dot, then (acc * sx) *
//               s[n], two separately rounded products: int8_mm.cu's op order,
//               so the outputs equal its bit for bit.
//
// What binds it. At the tool's shapes the bytes: the 4-byte [M, N] output
// is 84% of what the product must move (2048 x 512 x 4096: 33.6 of 39.8 MB)
// and the operations take at most 8.7 us at the bf16 rate. int8_mm.cu kept
// one k-tile in flight a block and wrote its tile only after its main loop,
// so neither its loads nor its output overlapped its products. Here, by the
// phase clock (tools/profile_int8.py --clock): bf16 is held by its
// consumers (the products, then both warpgroups' epilogue at once), the
// int8 forms by the producers' transposes and the raw loads behind them,
// dynq also by its band's quantization before the first tile.
//
// Design. One block an SM walks a slice of the N tiles of one M band (bpb
// blocks a band, `mm_plan`), so it keeps the band's rows, and dynq its rows'
// scales. Warpgroups 0 and 1 consume; the rest produce (one for bf16, two
// for the int8 forms' transposes: 384 or 512 threads), and setmaxnreg
// moves registers from them to the consumers. A ring of S stages in shared
// memory, each a B tile (and but for dynq an A tile [BM][128 bytes]),
// guarded by `full` and `empty` mbarriers:
//   bf16   one producer thread keeps TMA loads in flight: A [BM][64] bf16
//          K-major, B as [64 k][64 or 32 n] boxes of the row-major weight,
//          read MN-major by the descriptor (tnspB), each box swizzled as the
//          descriptor reads it (128 or 64 bytes).
//   int8   `wgmma` takes 8-bit operands K-major only, and the tool's contract
//          is w [K, N] as given: the producer thread loads each [128 k][BN]
//          block of w by TMA into a raw ring of R stages; the producer
//          warpgroups transpose it in 4 x 4 byte blocks (`transpose4x4_s8`)
//          into the stage's K-major, 128-byte-swizzled [BN][128] tile (the
//          lanes of each 8-lane store phase on 8 distinct 16-byte columns),
//          while A arrives by TMA straight into the stage.
//   dynq   as int8 for B. A is quantized once a block: all its threads take
//          the band's row amax over all of K, then write its int8 codes into
//          a resident [K / 128][BM][128] band of 128-byte-swizzled tiles,
//          which every tile's products read (a band is re-quantized by no
//          other tile of the block; the first raw B loads fly meanwhile).
// Consumers: BM = 128, each warpgroup 64 rows x BN; BM = 64, 64 rows x BN /
// 2 each. `wgmma` m64nNk16 (bf16 -> f32) or m64nNk32 (s8 -> s32), one group
// a stage, the previous stage released when the next is issued. Epilogue: the
// accumulators (dynq: scaled) to the warpgroup's shared C tile as
// 128-byte-swizzled [64][32] boxes, then TMA stores in a bulk group, which
// run under the next tile's products (the buffer is reused after
// `wait_group.read`).
//
// Planned in Python (tools/profile_int8.py `mm_plan`: the tile, S, R, the
// blocks a band and the shared-memory bytes, which `mw_smem` mirrors; a
// mismatch returns minus the kernel's bytes). Shapes: M and N multiples of
// the tile, K of 64 (bf16) or 128 (int8 forms), operands 16-byte aligned;
// otherwise cudaErrorInvalidValue.

#include "common.cuh"
#include "mbar_ring.cuh"
#include "mma_tc.cuh"
#include "wgmma.cuh"

enum { MW_BF16 = 0, MW_I8 = 1, MW_DYNQ = 2 };
#define MW_ROW 128  // bytes of a k-tile row: 64 bf16 or 128 int8

template <int MODE, int BM, int BN>
struct MwCfg {
  static constexpr int KT = MODE == MW_BF16 ? 64 : 128;       // k a stage
  static constexpr int WN = BM == 128 ? BN : BN / 2;          // columns a consumer warpgroup owns
  static constexpr int BOX_N = WN >= 64 ? 64 : 32;            // bf16 B box width (n)
  static constexpr int BOX_B = 64 * BOX_N * 2;                // bytes of a bf16 B box
  static constexpr int A_BYTES = MODE == MW_DYNQ ? 0 : BM * MW_ROW;  // A of a stage
  static constexpr int STAGE = A_BYTES + BN * MW_ROW;         // A and B of one stage
  static constexpr int RAW = MODE == MW_BF16 ? 0 : MW_ROW * BN;
  static constexpr int C_WG = 64 * WN * 4;                    // a consumer warpgroup's C tile
  // the producer warpgroups: bf16's one thread issues TMA loads; the int8
  // forms' transposes take two warpgroups, one unit of 16 k x 4 n a thread
  // at 128 x 128
  static constexpr int PWG = MODE == MW_BF16 ? 1 : 2;
  static constexpr int PROD = 128 * PWG, THREADS = 256 + PROD;
  static constexpr int FULL = MODE == MW_I8 ? PROD + 1 : (MODE == MW_DYNQ ? PROD : 1);
  // setmaxnreg: the block's registers (65,536 at one block an SM) moved from
  // the producers to the consumers
  static constexpr int PROD_REGS = MODE == MW_BF16 ? 40 : 64;
  static constexpr int CONS_REGS = MODE == MW_BF16 ? 232 : 192;
  static_assert((BM == 128 && BN == 128) || (BM == 64 && BN == 64), "tiles 128 x 128 or 64 x 64");
};

// The kernel's shared-memory bytes for S stages, R raw stages and depth K
// (1024 of them to align the base), in the order of the layout below
template <int MODE, int BM, int BN>
static int mw_smem(int S, int R, int K) {
  using C = MwCfg<MODE, BM, BN>;
  return 1024 + S * C::STAGE + R * C::RAW + 2 * C::C_WG
         + (MODE == MW_DYNQ ? BM * K + 4 * BM : 0) + 8 * (2 * S + 2 * R);
}

// The phase clock (tools/profile_int8.py `profile`): with a stamps buffer,
// each block writes MW_NSTAMP slots: 0 its start, 1 its prologue's end (dynq's
// band), 2 consumer 0's ns waiting on `full`, 3 its ns in epilogues, 4 the
// producer's ns waiting on raw stages, 5 on `empty`, 6 in its transforms
// (fences and barrier included), 7 the end (consumer 0's stores complete)
#define MW_NSTAMP 8

__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <typename T, int N>
__device__ __forceinline__ void zero(T (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0;
}

// The raw [128 k][BN] int8 block of w (row-major, unswizzled) as the stage's
// K-major [BN][128] tile, 128-byte swizzled: byte (n, k) at n * 128 +
// ((k / 16) ^ (n % 8)) * 16 + k % 16. A unit is 16 k x 4 n: 16 words read
// (conflict-free: a row's lanes on consecutive words), each word's 4 n
// rotated by rho = (ng / 2) % 4 (one PRMT), four 4 x 4 transposes, four
// 16-byte stores: the rotation puts each 8-lane store phase on 8 distinct
// 16-byte columns.
template <int BN, int PROD>
__device__ __forceinline__ void transpose_b(const uint8_t* raw, uint8_t* bt, int wt) {
#pragma unroll
  for (int u = wt; u < 2 * BN; u += PROD) {
    const int ng = u % (BN / 4), kb = u / (BN / 4), rho = (ng >> 1) & 3;
    const uint32_t rot = ((rho + 0) & 3) | (((rho + 1) & 3) << 4) | (((rho + 2) & 3) << 8)
                         | (((rho + 3) & 3) << 12);
    uint32_t w[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[q][r] = __byte_perm(
            *reinterpret_cast<const uint32_t*>(raw + (kb * 16 + q * 4 + r) * BN + ng * 4), 0, rot);
#pragma unroll
    for (int q = 0; q < 4; ++q) transpose4x4_s8(w[q]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = ng * 4 + ((j + rho) & 3);
      *reinterpret_cast<uint4*>(bt + n * MW_ROW + ((kb ^ (n & 7)) << 4)) =
          make_uint4(w[0][j], w[1][j], w[2][j], w[3][j]);
    }
  }
}

__device__ __forceinline__ float amax8(uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a = fmaxf(a, fmaxf(fabsf(__uint_as_float(w[i] << 16)), fabsf(__uint_as_float(w[i] & 0xffff0000u))));
  return a;
}

// int8_mm.cu's `quant2` on 8 bf16 values (4 pairs): round_half_even(fl(v /
// dv)), an IEEE division, as two words of int8 codes. `quant8` gives the
// same bits without the division: t = fl(v * rc), rc = fl(1 / dv), and
// fl(t + 1.5 * 2^23) holds round_half_even(t) in its low byte (|t| < 2^22).
// For |v / dv| < 128 (v of the row, dv >= fl(amax * fl(1/127))) t is within
// 2^-16 of v / dv and fl(v / dv) within 2^-17, so where t lies 2^-15 or
// more from every half-integer both round to the same integer; `amb` is set
// where one lies nearer, and the caller divides instead.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__device__ __forceinline__ uint2 quant8(uint4 u, float rc, bool& amb) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float v = __uint_as_float(i & 1 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
    const float t = __fmul_rn(v, rc), sum = __fadd_rn(t, 0x1.8p23f);
    amb |= fabsf(fabsf(__fsub_rn(t, __fsub_rn(sum, 0x1.8p23f))) - 0.5f) < 0x1p-15f;
    b[i] = __float_as_uint(sum);
  }
  return make_uint2(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]));
}

__device__ __noinline__ uint2 quant8_div(uint4 u, float dv) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float v = __uint_as_float(i & 1 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
    b[i] = (uint32_t)__float2int_rn(__fdiv_rn(v, dv));
  }
  return make_uint2(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]));
}

// dynq's band, by all the block's threads, a warp 4 rows at a time (8 loads
// in flight a lane): sx[m] = amax(|x[m0 + m, :]|) * f32(1/127), then each
// 8 values of the row quantized by max(sx[m], 1e-30) (`quant8`) into the
// band: row m of k-tile k / 128 at (k / 128) * BM * 128 + m * 128, its
// 16-byte column (k % 128) / 16 swizzled by m % 8. At K <= 512 the row's
// values stay in registers between the two; past it they are read again.
template <int BM, int THREADS>
__device__ __forceinline__ void quantize_band(const uint16_t* __restrict__ x, int m0, int K,
                                              float* sx, uint8_t* band) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n8 = K / 8;
  for (int r0 = warp * 4; r0 < BM; r0 += 4 * (THREADS / 32)) {
    const uint4* rows[4];
    uint4 v[4][2];
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    auto load = [&](int cb) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = cb + lane + 32 * h;
          v[r][h] = c < n8 ? __ldg(rows[r] + c) : make_uint4(0, 0, 0, 0);
        }
    };
#pragma unroll
    for (int r = 0; r < 4; ++r) rows[r] = reinterpret_cast<const uint4*>(x + (size_t)(m0 + r0 + r) * K);
    for (int cb = 0; cb < n8; cb += 64) {
      load(cb);
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = fmaxf(a[r], fmaxf(amax8(v[r][0]), amax8(v[r][1])));
    }
    float dv[4], rc[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float sxr = __fmul_rn(warp_max(a[r]), INV127);
      if (lane == 0) sx[r0 + r] = sxr;
      dv[r] = fmaxf(sxr, ROWQ_FLOOR);
      rc[r] = __frcp_rn(dv[r]);
    }
    for (int cb = 0; cb < n8; cb += 64) {
      if (n8 > 64) load(cb);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = cb + lane + 32 * h, m = r0 + r;
          if (c >= n8) continue;
          bool amb = false;
          uint2 q = quant8(v[r][h], rc[r], amb);
          if (amb) q = quant8_div(v[r][h], dv[r]);
          *reinterpret_cast<uint2*>(band + (c >> 4) * BM * MW_ROW + m * MW_ROW
                                    + ((((c & 15) >> 1) ^ (m & 7)) << 4) + ((c & 1) << 3)) = q;
        }
    }
  }
}

template <int MODE, int N>
struct Mma;
template <>
struct Mma<MW_BF16, 128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    wgmma_bf16_n128(d, a, b, acc);
  }
};
template <>
struct Mma<MW_BF16, 32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    wgmma_bf16_n32(d, a, b, acc);
  }
};
template <int MODE>
struct Mma<MODE, 128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t a, uint64_t b, int acc) {
    wgmma_s8_n128(d, a, b, acc);
  }
};
template <int MODE>
struct Mma<MODE, 32> {
  static __device__ __forceinline__ void run(int (&d)[16], uint64_t a, uint64_t b, int acc) {
    wgmma_s8_n32(d, a, b, acc);
  }
};

struct MwSmem {
  uint8_t* ring;      // [S][STAGE]
  uint8_t* raw;       // [R][RAW]
  uint8_t* cbuf;      // [2][C_WG]
  uint8_t* band;      // dynq: [K / 128][BM][128] the band's int8 codes
  float* sx;          // dynq: [BM] the band's row scales
  uint64_t* full;     // [S]
  uint64_t* empty;    // [S]
  uint64_t* rawfull;  // [R]
  uint64_t* rawempty; // [R]
};

// The block's tiles: the N tiles [nt0, nt1) of the band at row m0
struct MwTiles {
  int m0, nt0, nt1, KTN;
  __device__ __forceinline__ int total() const { return (nt1 - nt0) * KTN; }
};

// int8 and dynq: w's raw [128 k][BN] blocks by TMA, R ahead of the transform
template <int MODE, int BM, int BN>
__device__ __forceinline__ void issue_raw(const MwSmem& L, const CUtensorMap* tB, const MwTiles& T,
                                          int idx, int R) {
  using C = MwCfg<MODE, BM, BN>;
  uint64_t* bar = L.rawfull + idx % R;
  mbar_expect(bar, C::RAW);
  tma_load_2d(L.raw + (idx % R) * C::RAW, tB, (T.nt0 + idx / T.KTN) * BN, (idx % T.KTN) * 128, bar);
}

template <int MODE, int BM, int BN>
__device__ __forceinline__ void producer(const MwSmem& L, const CUtensorMap* tA, const CUtensorMap* tB,
                                         const MwTiles& T, int S, int R, unsigned long long* clk) {
  using C = MwCfg<MODE, BM, BN>;
  const int wt = threadIdx.x - 256, total = T.total();
  int s = 0, ph = 0;
  if constexpr (MODE == MW_BF16) {
    if (wt != 0) return;
    unsigned long long t_empty = 0, t0 = 0;
    for (int idx = 0; idx < total; ++idx) {
      const int kt = idx % T.KTN, n0 = (T.nt0 + idx / T.KTN) * BN;
      if (clk) t0 = gtimer();
      mbar_wait(L.empty + s, ph ^ 1);
      if (clk) t_empty += gtimer() - t0;
      uint8_t* st = L.ring + s * C::STAGE;
      mbar_expect(L.full + s, C::STAGE);
      tma_load_2d(st, tA, kt * 64, T.m0, L.full + s);
#pragma unroll
      for (int j = 0; j < BN / C::BOX_N; ++j)
        tma_load_2d(st + C::A_BYTES + j * C::BOX_B, tB, n0 + j * C::BOX_N, kt * 64, L.full + s);
      if (++s == S) s = 0, ph ^= 1;
    }
    if (clk) clk[5] = t_empty;
  } else {
    // the first R raw loads were issued before the block's prologue; a raw
    // stage is refilled once its PROD readers have arrived on `rawempty`
    unsigned long long t_raw = 0, t_empty = 0, t_work = 0, t0 = 0, t1 = 0;
    for (int idx = 0; idx < total; ++idx) {
      const int r = idx % R;
      if (clk) t0 = gtimer();
      if (wt == 0 && idx > 0 && idx - 1 + R < total) {
        mbar_wait(L.rawempty + (idx - 1) % R, ((idx - 1) / R) & 1);
        issue_raw<MODE, BM, BN>(L, tB, T, idx - 1 + R, R);
      }
      mbar_wait(L.rawfull + r, (idx / R) & 1);
      if (clk) t1 = gtimer(), t_raw += t1 - t0;
      mbar_wait(L.empty + s, ph ^ 1);
      if (clk) t0 = gtimer(), t_empty += t0 - t1;
      uint8_t* st = L.ring + s * C::STAGE;
      if (MODE == MW_I8 && wt == 0) {
        mbar_expect(L.full + s, C::A_BYTES);
        tma_load_2d(st, tA, (idx % T.KTN) * 128, T.m0, L.full + s);
      }
      transpose_b<BN, C::PROD>(L.raw + r * C::RAW, st + C::A_BYTES, wt);
      mbar_arrive(L.rawempty + r);
      fence_proxy_async();
      mbar_arrive(L.full + s);
      if (clk) t_work += gtimer() - t0;
      if (++s == S) s = 0, ph ^= 1;
    }
    if (clk && wt == 0) clk[4] = t_raw, clk[5] = t_empty, clk[6] = t_work;
  }
}

template <int MODE, int BM, int BN>
__device__ __forceinline__ void consumer(const MwSmem& L, const CUtensorMap* tC,
                                         const float* __restrict__ scale, const MwTiles& T, int S,
                                         unsigned long long* clk) {
  using C = MwCfg<MODE, BM, BN>;
  using Acc = typename std::conditional<MODE == MW_BF16, float, int>::type;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int rowoff = BM == 128 ? wg * 64 : 0, coloff = BM == 128 ? 0 : wg * C::WN;
  uint8_t* cwg = L.cbuf + wg * C::C_WG;
  Acc acc[C::WN / 2];
  zero(acc);
  float sxr[2] = {0.f, 0.f};
  if (MODE == MW_DYNQ) {
    sxr[0] = L.sx[rowoff + warp * 16 + g];
    sxr[1] = L.sx[rowoff + warp * 16 + g + 8];
  }
  int s = 0, ph = 0, prev = 0;
  unsigned long long t_full = 0, t_epi = 0, t0 = 0;
  for (int nt = T.nt0; nt < T.nt1; ++nt) {
    const int n0 = nt * BN;
    for (int kt = 0; kt < T.KTN; ++kt) {
      if (clk) t0 = gtimer();
      mbar_wait(L.full + s, ph);
      if (clk) t_full += gtimer() - t0;
      const uint8_t* st = L.ring + s * C::STAGE;
      const uint8_t* a = MODE == MW_DYNQ ? L.band + kt * BM * MW_ROW : st;
      const uint64_t da = wg_desc(a + rowoff * MW_ROW, 16, 1024, 1);
      uint64_t db;
      if (MODE == MW_BF16)
        db = wg_desc(st + C::A_BYTES + (coloff / C::BOX_N) * C::BOX_B, C::BOX_B, 8 * C::BOX_N * 2,
                     C::BOX_N == 64 ? 1 : 2);
      else
        db = wg_desc(st + C::A_BYTES + coloff * MW_ROW, 16, 1024, 1);
      wgmma_fence();
      wgmma_fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bstep = MODE == MW_BF16 ? (uint64_t)(16 * C::BOX_N * 2 >> 4) : 2;
        Mma<MODE, C::WN>::run(acc, da + 2 * kk, db + bstep * kk, (kt | kk) != 0);
      }
      wgmma_commit();
      wgmma_fence_acc(acc);
      if (kt > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(L.empty + prev);
      }
      prev = s;
      if (++s == S) s = 0, ph ^= 1;
    }
    wgmma_wait<0>();
    wgmma_fence_acc(acc);
    if (lane == 0) mbar_arrive(L.empty + prev);
    if (clk) t0 = gtimer();

    // epilogue: the C tile once the last tile's store has read it
    if (wt == 0) bulk_wait_read0();
    named_bar(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < C::WN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + g + 8 * h, col = 8 * j + 2 * q;
        const Acc v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        uint2 bits;
        if constexpr (MODE == MW_BF16) {
          bits = make_uint2(__float_as_uint(v0), __float_as_uint(v1));
        } else if constexpr (MODE == MW_I8) {
          bits = make_uint2((uint32_t)v0, (uint32_t)v1);
        } else {
          const float2 sc = __ldg(reinterpret_cast<const float2*>(scale + n0 + coloff + col));
          bits = make_uint2(__float_as_uint(__fmul_rn(__fmul_rn(__int2float_rn(v0), sxr[h]), sc.x)),
                            __float_as_uint(__fmul_rn(__fmul_rn(__int2float_rn(v1), sxr[h]), sc.y)));
        }
        *reinterpret_cast<uint2*>(cwg + (col >> 5) * 8192 + row * 128
                                  + ((((col & 31) >> 2) ^ (row & 7)) << 4) + ((col & 3) << 2)) = bits;
      }
    fence_proxy_async();
    named_bar(1 + wg, 128);
    if (wt == 0) {
#pragma unroll
      for (int b = 0; b < C::WN / 32; ++b)
        tma_store_2d(tC, cwg + b * 8192, n0 + coloff + 32 * b, T.m0 + rowoff);
      bulk_commit();
    }
    if (clk) t_epi += gtimer() - t0;
  }
  if (wt == 0) bulk_wait0();
  if (clk && tid == 0) clk[2] = t_full, clk[3] = t_epi, clk[7] = gtimer();
}

// out [M, N] = a [M, K] x b [K, N] in form MODE; s [N] (dynq's column
// scales); block b takes slice b % bpb of band b / bpb's N tiles
template <int MODE, int BM, int BN>
__global__ void __launch_bounds__(MwCfg<MODE, BM, BN>::THREADS, 1)
    mm_wgmma_kernel(__grid_constant__ const CUtensorMap tA, __grid_constant__ const CUtensorMap tB,
                    __grid_constant__ const CUtensorMap tC, const float* __restrict__ s,
                    const uint16_t* __restrict__ x, unsigned long long* stamps, int N, int K, int S,
                    int R, int bpb) {
  using C = MwCfg<MODE, BM, BN>;
  unsigned long long* clk = stamps ? stamps + (size_t)blockIdx.x * MW_NSTAMP : nullptr;
  if (clk && threadIdx.x == 0) clk[0] = gtimer();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  MwSmem L;
  L.ring = base;
  L.raw = L.ring + S * C::STAGE;
  L.cbuf = L.raw + R * C::RAW;
  L.band = L.cbuf + 2 * C::C_WG;
  L.sx = reinterpret_cast<float*>(L.band + (MODE == MW_DYNQ ? BM * K : 0));
  L.full = reinterpret_cast<uint64_t*>(L.sx + (MODE == MW_DYNQ ? BM : 0));
  L.empty = L.full + S;
  L.rawfull = L.empty + S;
  L.rawempty = L.rawfull + R;

  const int NTN = N / BN, j = blockIdx.x % bpb;
  const MwTiles T{(int)(blockIdx.x / bpb) * BM, j * NTN / bpb, (j + 1) * NTN / bpb, K / C::KT};
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(L.full + i, C::FULL);
      mbar_init(L.empty + i, 8);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < R; ++i) {
      mbar_init(L.rawfull + i, 1);
      mbar_init(L.rawempty + i, C::PROD);  // the producer warpgroups
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (MODE != MW_BF16 && threadIdx.x == 256)
    for (int i = 0; i < R && i < T.total(); ++i) issue_raw<MODE, BM, BN>(L, &tB, T, i, R);
  if constexpr (MODE == MW_DYNQ) {
    quantize_band<BM, C::THREADS>(x, T.m0, K, L.sx, L.band);
    fence_proxy_async();
    __syncthreads();
  }
  if (clk && threadIdx.x == 0) clk[1] = gtimer();
  if (threadIdx.x >= 256) {
    setmaxnreg_dec<C::PROD_REGS>();
    producer<MODE, BM, BN>(L, &tA, &tB, T, S, R, clk);
  } else {
    setmaxnreg_inc<C::CONS_REGS>();
    consumer<MODE, BM, BN>(L, &tC, s, T, S, clk);
  }
}

// -- host ---------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A row-major [rows][cols] matrix of `esize`-byte elements as a tensor map
// of boxes [box_r][box_c] (cuTensorMapEncodeTiled, from the driver through
// the runtime); 0 or a CUDA error
static int tensor_map(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* p,
                      int rows, int cols, int box_r, int box_c, CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &q);
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess || encode == nullptr)
      return err != cudaSuccess ? (int)err : (int)cudaErrorSymbolNotFound;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_c, (cuuint32_t)box_r};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(p), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int MODE, int BM, int BN>
static int launch_mw(const void* a, const void* b, const float* s, void* out,
                     unsigned long long* stamps, int M, int K, int N, int S, int R, int smem, int bpb,
                     cudaStream_t stream) {
  using C = MwCfg<MODE, BM, BN>;
  if (M <= 0 || N <= 0 || K <= 0 || M % BM || N % BN || K % C::KT || S < 2
      || (MODE == MW_BF16) != (R == 0) || R < 0 || bpb < 1 || bpb > N / BN)
    return (int)cudaErrorInvalidValue;
  const int need = mw_smem<MODE, BM, BN>(S, R, K);
  if (smem != need) return -need;
  auto kern = mm_wgmma_kernel<MODE, BM, BN>;
  // setmaxnreg moves registers within the block's allocation: the launch
  // must hold what the warpgroups ask for, or the consumers would wait
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kern);
    if (err != cudaSuccess) return (int)err;
    regs = fa.numRegs;
  }
  if (regs * C::THREADS < C::PROD * C::PROD_REGS + 256 * C::CONS_REGS)
    return (int)cudaErrorInvalidConfiguration;
  static int smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  CUtensorMap tA, tB, tC;
  int rc;
  if (MODE == MW_I8)
    rc = tensor_map(&tA, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a, M, K, BM, 128,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  else
    rc = tensor_map(&tA, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, M, K, BM, 64,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  if (MODE == MW_BF16)
    rc = tensor_map(&tB, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, K, N, 64, C::BOX_N,
                    C::BOX_N == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  else
    rc = tensor_map(&tB, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, b, K, N, 128, BN,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc) return rc;
  rc = tensor_map(&tC, MODE == MW_I8 ? CU_TENSOR_MAP_DATA_TYPE_INT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  4, out, M, N, 64, 32, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  kern<<<(M / BM) * bpb, C::THREADS, smem, stream>>>(tA, tB, tC, s, (const uint16_t*)a, stamps, N,
                                                     K, S, R, bpb);
  return (int)cudaGetLastError();
}

template <int MODE>
static int dispatch(const void* a, const void* b, const float* s, void* out,
                    unsigned long long* stamps, int M, int K, int N, int bm, int bn, int S, int R,
                    int smem, int bpb, void* stream) {
  if (bm == 128 && bn == 128)
    return launch_mw<MODE, 128, 128>(a, b, s, out, stamps, M, K, N, S, R, smem, bpb,
                                     (cudaStream_t)stream);
  if (bm == 64 && bn == 64)
    return launch_mw<MODE, 64, 64>(a, b, s, out, stamps, M, K, N, S, R, smem, bpb,
                                   (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// The plan's tile (bm x bn), stages S, raw stages R, shared-memory bytes
// and blocks a band (the grid is M / bm bands of bpb blocks); `stamps`
// null, or [grid][MW_NSTAMP] for the phase clock. Each returns minus the
// kernel's bytes where `smem` differs (nothing launched), else the launch's
// error.

// x bf16 [M, K], w bf16 [K, N] -> out f32 [M, N]
extern "C" int mm_wgmma_bf16(const void* x, const void* w, float* out, unsigned long long* stamps,
                             int M, int K, int N, int bm, int bn, int S, int R, int smem, int bpb,
                             void* stream) {
  return dispatch<MW_BF16>(x, w, nullptr, out, stamps, M, K, N, bm, bn, S, R, smem, bpb, stream);
}

// x int8 [M, K], w int8 [K, N] -> out int32 [M, N]
extern "C" int mm_wgmma_i8(const int8_t* x, const int8_t* w, int* out, unsigned long long* stamps,
                           int M, int K, int N, int bm, int bn, int S, int R, int smem, int bpb,
                           void* stream) {
  return dispatch<MW_I8>(x, w, nullptr, out, stamps, M, K, N, bm, bn, S, R, smem, bpb, stream);
}

// x bf16 [M, K], w int8 [K, N], s f32 [N] -> out f32 [M, N]
extern "C" int mm_wgmma_dynq(const void* x, const int8_t* w, const float* s, float* out,
                             unsigned long long* stamps, int M, int K, int N, int bm, int bn, int S,
                             int R, int smem, int bpb, void* stream) {
  return dispatch<MW_DYNQ>(x, w, s, out, stamps, M, K, N, bm, bn, S, R, smem, bpb, stream);
}
