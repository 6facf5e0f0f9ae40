// Mamba2 SSD (state-space dual) core for Hopper (sm_90a), chunk-dual form,
// its products on the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba2_ssd/kernel.py::_ssd_kernel
// (launched by ssd_fwd).  Its plain PyTorch version is
// src/repro_torch/kernels/mamba2_ssd/ref.py::ssd_chunked.  Per (batch, head),
// over chunks of 64 rows, with cum the inclusive cumsum of dt * a inside the
// chunk (kept in base 2: cum = cumsum(dt * a * log2 e)) and total its last
// value:
//   intra  y_i += sum_{j<=i} (C_i . B_j) exp2(cum_i - cum_j) dt_j x_j
//   inter  y_i += exp2(cum_i) C_i S
//   state  S    = exp2(total) S + sum_j (exp2(total - cum_j) dt_j B_j)^T x_j
// and the final S is written in fp32.  Every exponent is <= 0 (a < 0, dt > 0,
// and the pair decay is taken only where j <= i), so nothing overflows under
// a strong decay; each exp2 is one ex2.approx (relative error about 2^-22).
//
// What bounds it on the card: bytes, counting each input read once and each
// output written once (about 2.8e8 at the zamba2-1.2b serving shape B = 4,
// L = 4096, H = 64, P = N = 64, x/B/C bf16, dt fp32: 0.084 ms at 3.35 TB/s,
// against 2.6e10 flop).  What this design does about the rest:
//   * Tensor cores.  C B^T, the scaled score times x, C S and the state
//     product run as mma.sync.m16n8k16 bf16 -> fp32.  Each fp32 operand is
//     split into a bf16 high part and a bf16 remainder and the product taken
//     as hi*hi + hi*lo + lo*hi: one bf16 rounding of the state product's
//     weighted B, of the score or of S exceeds the tolerances
//     (tests/test_torch_mamba2_ssd.py emulates both).  bf16 x, B and C are
//     exact and skip their remainder, so on the bf16 route C B^T is one MMA
//     and the others two; their fragments come straight from shared memory
//     by ldmatrix.  The fp32 route runs the same code with every operand
//     split.
//   * Registers.  A block is 4 warps, one per 16-row sub-chunk of queries.
//     C B^T covers only the lower-triangle column blocks and shares its pass
//     over N (and C's fragments) with C S, which goes into the y
//     accumulator and is scaled by exp2(cum_i) on its rows.  The C B^T
//     accumulator is scaled by the decay and dt_j in registers and, being in
//     the A layout of the next product, is split and multiplied by x without
//     going through shared memory.  The carried state stays fp32 in
//     registers as the accumulator of its own product, its N rows spread
//     over the warps; its bf16 hi/lo copy for the next chunk's C S is
//     written by stmatrix, transposed into [P][N], so that its B fragments
//     come back by ldmatrix.
//   * One barrier per chunk.  The next chunk's x, B, C and dt arrive by
//     cp.async into a second stage while this chunk computes (rows past L
//     and padding columns are zero-filled by the copy: the JAX wrapper's
//     identity padding, dt = 0); the state copy is double-buffered; the
//     cumsum is a shuffle scan that each warp runs for itself.
//   * One wave.  One block per (batch, head, 64-column tile of P) walks its
//     chunks in order (the TPU's sequential grid axis becomes this loop);
//     nothing carries between blocks.  At the serving shape a block takes
//     94,720 bytes of shared memory, so two share an SM and the 256 blocks
//     are resident at once on 132 SMs.
// What holds it back now (compare_flash.py --kernel ssd on an H100, variants
// with one part removed, results wrong, time only): of 0.285 ms, the state
// product takes 0.046, C B^T with the intra product 0.061 and C S 0.033;
// the rest is the chunk loop itself (copies, scan, barrier, y stores, the
// state copy).  Measured slower on the same card: P tiles of 32 (512
// blocks, three an SM), two heads a block sharing B, C and C B^T (128
// blocks), 8 warps with two a sub-chunk splitting the P tile, and the state
// units shared unevenly to offset the later sub-chunks' extra score blocks.
// N is padded to the next of 16, 32, 64, 128 with zero channels and P to
// the tile with zero columns.  N and P are multiples of 16 up to 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kChunk = 64;  // ops.CHUNK on the Python side
constexpr int kSub = 16;  // rows of a sub-chunk: one warp's query rows
constexpr int kWarps = kChunk / kSub;
constexpr int kThreads = 32 * kWarps;
constexpr int kPTile = 64;  // P columns per block
constexpr int kMaxDim = 128;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// exp2 of min(x, 0) on the special-function unit (relative error about
// 2^-22, results below 2^-126 flushed to 0: far inside the tolerances)
__device__ __forceinline__ float exp2_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(fminf(x, 0.0f)));
  return y;
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 x) { return *reinterpret_cast<uint32_t*>(&x); }
__device__ __forceinline__ float2 unpack(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// (a, b) -> bf16 high parts and bf16 remainders, a in the low half
__device__ __forceinline__ void split(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// A 16 x 16 bf16 operand of mma.m16n8k16 in its register layout (row-major:
// thread (g, t) holds rows g, g + 8 and columns 2t, 2t + 1, 2t + 8, 2t + 9),
// as high parts and remainders (an exact operand leaves lo unset)
struct FragA {
  uint32_t hi[4], lo[4];
  // p[0]: (g, 2t..), p[1]: (g + 8, 2t..), p[2]: (g, 2t + 8..), p[3]: (g + 8, 2t + 8..)
  __device__ __forceinline__ void set(const float2 (&p)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) split(p[e].x, p[e].y, hi[e], lo[e]);
  }
};

// A 16 x 8 operand (K x N, column-major: thread (g, t) holds rows 2t, 2t + 1,
// 2t + 8, 2t + 9 of column g)
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b as hi*hi + lo*hi + hi*lo, skipping the remainder of an exact operand
template <bool a_exact, bool b_exact>
__device__ __forceinline__ void mma_split(float (&c)[4], const FragA& a, const FragB& b) {
  mma(c, a.hi, b.hi);
  if (!a_exact) mma(c, a.lo, b.hi);
  if (!b_exact) mma(c, a.hi, b.lo);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// four 8 x 8 bf16 matrices in the accumulator's pair layout, stored
// transposed: lane l gives the address of stored row l & 7 of matrix l >> 3
__device__ __forceinline__ void stsm_x4_trans(void* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n"
               ::"r"(smem_addr(p)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// global -> shared; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

// Fragment loads from shared memory, S the row stride in elements.  bf16 is
// exact and comes by ldmatrix; fp32 is gathered and split.
// A: rows r..r + 15, columns k..k + 15 of a row-major [row][k] array at base
template <typename T, int S>
__device__ __forceinline__ FragA load_a(const T* base, int lane) {
  FragA f;
  if constexpr (kIsBf16<T>) {
    ldsm_x4(f.hi, base + (lane & 15) * S + 8 * (lane >> 4));
  } else {
    const int g = lane >> 2, t = lane & 3;
    const float2 p[4] = {load2(base + g * S + 2 * t), load2(base + (g + 8) * S + 2 * t),
                         load2(base + g * S + 2 * t + 8), load2(base + (g + 8) * S + 2 * t + 8)};
    f.set(p);
  }
  return f;
}

// A of (w B)^T: rows n..n + 15, columns j..j + 15 from a [j][n] array at
// base, column j scaled by w_j (wl: j = 2t, 2t + 1; wh: j = 2t + 8, 2t + 9);
// always split
template <typename T, int S>
__device__ __forceinline__ FragA load_a_trans_scaled(const T* base, float2 wl, float2 wh, int lane) {
  float2 p[4];
  if constexpr (kIsBf16<T>) {
    uint32_t r[4];  // (n = g, j = 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)
    ldsm_x4_trans(r, base + ((lane & 7) + 8 * (lane >> 4)) * S + 8 * ((lane >> 3) & 1));
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = unpack(r[e]);
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = g + 8 * (e & 1), j = 2 * t + 8 * (e >> 1);
      p[e] = make_float2(base[j * S + n], base[(j + 1) * S + n]);
    }
  }
  FragA f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 w = e < 2 ? wl : wh;
    p[e] = make_float2(p[e].x * w.x, p[e].y * w.y);
  }
  f.set(p);
  return f;
}

// B of two n8 tiles from an [n][k] array (rows n..n + 15, columns k..k + 15)
template <typename T, int S>
__device__ __forceinline__ void load_b_nk(FragB (&fb)[2], const T* base, int lane) {
  if constexpr (kIsBf16<T>) {
    uint32_t r[4];
    ldsm_x4(r, base + ((lane & 7) + 8 * (lane >> 4)) * S + 8 * ((lane >> 3) & 1));
    fb[0].hi[0] = r[0], fb[0].hi[1] = r[1], fb[1].hi[0] = r[2], fb[1].hi[1] = r[3];
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 v = load2(base + (8 * nt + g) * S + 2 * t + 8 * e);
        split(v.x, v.y, fb[nt].hi[e], fb[nt].lo[e]);
      }
  }
}

// B of two n8 tiles from a [k][n] array (rows k..k + 15, columns n..n + 15)
template <typename T, int S>
__device__ __forceinline__ void load_b_kn(FragB (&fb)[2], const T* base, int lane) {
  if constexpr (kIsBf16<T>) {
    uint32_t r[4];
    ldsm_x4_trans(r, base + (lane & 15) * S + 8 * (lane >> 4));
    fb[0].hi[0] = r[0], fb[0].hi[1] = r[1], fb[1].hi[0] = r[2], fb[1].hi[1] = r[3];
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 2 * t + 8 * e, col = 8 * nt + g;
        split(base[k * S + col], base[(k + 1) * S + col], fb[nt].hi[e], fb[nt].lo[e]);
      }
  }
}

// Shared-memory layout of one instance (NP: N padded)
template <typename T, int NP>
struct Layout {
  static constexpr int kE = 16 / int(sizeof(T));  // elements per 16-byte copy
  static constexpr int kBS = NP + 8;              // B and C rows: fragment loads hit distinct banks
  static constexpr int kXS = kPTile + kE;         // x rows
  static constexpr int kSS = NP + 8;              // rows of the state copy, [P][N] bf16
  // per stage: B [Q][BS], C [Q][BS], x [Q][XS] in T; dt [Q] fp32
  static constexpr int kStageBytes = (2 * kChunk * kBS + kChunk * kXS) * int(sizeof(T)) + kChunk * 4;
  // two buffers x (hi, lo) x [P tile][SS] bf16
  static constexpr int kStateBytes = 2 * 2 * kPTile * kSS * 2;
  // per warp: cum and the state weights exp2(total - cum_j) dt_j
  static constexpr int kScanBytes = kWarps * 2 * kChunk * 4;
  static constexpr int kFixedBytes = kStateBytes + kScanBytes;
  static constexpr int kStages = kFixedBytes + 2 * kStageBytes <= kSmemLimit ? 2 : 1;
  static constexpr int kBytes = kFixedBytes + kStages * kStageBytes;
};

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads) ssd_kernel(
    const T* __restrict__ x,       // (B, L, H, P)
    const float* __restrict__ dt,  // (B, L, H)
    const float* __restrict__ a,   // (H,)
    const T* __restrict__ bm,      // (B, L, N)
    const T* __restrict__ cm,      // (B, L, N)
    T* __restrict__ y,             // (B, L, H, P)
    float* __restrict__ state,     // (B, H, N, P)
    int l, int h, int p, int n) {
  using L = Layout<T, NP>;
  constexpr int BS = L::kBS, XS = L::kXS, SS = L::kSS, kE = L::kE;
  constexpr int kStages = L::kStages;
  constexpr bool kExact = kIsBf16<T>;  // x, B and C have no remainder
  constexpr int kKSteps = NP / 16;
  constexpr int kYTiles = kPTile / 8;
  // the state's m16 (N) x n16 (P) units, spread over the warps in order
  constexpr int kNPairs = kPTile / 16;
  constexpr int kUnits = (NP / 16) * kNPairs;
  constexpr int kMine = kUnits / kWarps;
  constexpr int kMTiles = kMine >= kNPairs ? kMine / kNPairs : 1;
  constexpr int kNP = kMine >= kNPairs ? kNPairs : kMine;

  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  __nv_bfloat16* s_st = reinterpret_cast<__nv_bfloat16*>(smem + kStages * L::kStageBytes);
  float* s_scan = reinterpret_cast<float*>(smem + kStages * L::kStageBytes + L::kStateBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_pt = (p + kPTile - 1) / kPTile;
  const int bh = blockIdx.x / n_pt;
  const int p0 = (blockIdx.x % n_pt) * kPTile;
  const int bi = bh / h;
  const int hi = bh % h;
  const int nv = min(kPTile, p - p0);  // a multiple of 16
  const int n_chunks = (l + kChunk - 1) / kChunk;
  const size_t row0 = static_cast<size_t>(bi) * l;
  const float al2 = a[hi] * kLog2e;

  // one chunk's B, C, x and dt into a stage; rows past L, channels past N
  // and columns past the P tile are zero-filled
  auto load = [&](int c, int stage) {
    T* s_b = reinterpret_cast<T*>(smem + stage * L::kStageBytes);
    T* s_x = s_b + 2 * kChunk * BS;
    float* s_dt = reinterpret_cast<float*>(s_x + kChunk * XS);
    constexpr int kBP = NP / kE;  // 16-byte pieces of a B or C row
    for (int idx = tid; idx < kChunk * 2 * kBP; idx += kThreads) {
      const int row = idx / (2 * kBP), mat = (idx / kBP) & 1, col = (idx % kBP) * kE;
      const int lrow = c * kChunk + row;
      const bool live = lrow < l && col < n;
      const T* src = (mat ? cm : bm) + (row0 + (lrow < l ? lrow : 0)) * n + (live ? col : 0);
      cp_async16(s_b + (mat * kChunk + row) * BS + col, src, live ? 16 : 0);
    }
    constexpr int kXP = kPTile / kE;  // 16-byte pieces of an x row
    for (int idx = tid; idx < kChunk * kXP; idx += kThreads) {
      const int row = idx / kXP, col = (idx % kXP) * kE;
      const int lrow = c * kChunk + row;
      const bool live = lrow < l && col < nv;
      const T* src = x + ((row0 + (lrow < l ? lrow : 0)) * h + hi) * p + p0 + (live ? col : 0);
      cp_async16(s_x + row * XS + col, src, live ? 16 : 0);
    }
    if (tid < kChunk) {
      const int lrow = c * kChunk + tid;
      const bool live = lrow < l;
      cp_async4(s_dt + tid, dt + (row0 + (live ? lrow : 0)) * h + hi, live ? 4 : 0);
    }
  };

  // this warp's state units, fp32, carried over the whole sequence
  const int m0 = warp * kMine / kNPairs;      // first m16 tile of N
  const int np0 = (warp * kMine) % kNPairs;  // first n16 pair of the P tile
  float acc_s[kMTiles][2 * kNP][4];
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
    for (int nt = 0; nt < 2 * kNP; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_s[mi][nt][e] = 0.0f;
  // the state copy that chunk 0 reads is zero
  for (int idx = tid; idx < 2 * kPTile * SS; idx += kThreads) s_st[idx] = __float2bfloat16_rn(0.0f);

  load(0, 0);
  cp_async_commit();

  const int sa = warp;  // this warp's query sub-chunk
  const int i0 = kSub * sa + g, i1 = i0 + 8;  // chunk rows of this thread's accumulator entries
  float* cum = s_scan + warp * 2 * kChunk;  // this warp's copy of cum
  float* wt = cum + kChunk;                 // and of the state weights
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * kChunk;
    const int q = min(kChunk, l - c0);  // real rows of this chunk
    const int stage = kStages == 2 ? (c & 1) : 0;
    if (kStages == 1 && c > 0) {
      __syncthreads();  // the previous chunk's reads of the stage are done
      load(c, 0);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();  // this chunk's inputs and the previous chunk's state copy are visible
    if (kStages == 2 && c + 1 < n_chunks) {
      load(c + 1, (c + 1) & 1);  // into the stage the previous chunk used
      cp_async_commit();
    }
    const T* s_b = reinterpret_cast<const T*>(smem + stage * L::kStageBytes);
    const T* s_c = s_b + kChunk * BS;
    const T* s_x = s_c + kChunk * BS;
    const float* s_dt = reinterpret_cast<const float*>(s_x + kChunk * XS);
    const __nv_bfloat16* sth = s_st + (c & 1) * 2 * kPTile * SS;  // this chunk's state copy
    const __nv_bfloat16* stl = sth + kPTile * SS;

    // cum and the state weights, each warp its own copy: lane holds rows
    // 2 lane and 2 lane + 1, their offset from a shuffle scan
    float total;
    {
      const float d0 = s_dt[2 * lane], d1 = s_dt[2 * lane + 1];
      const float l0 = d0 * al2, l1 = d1 * al2;
      float inc = l0 + l1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) excl = 0.0f;
      const float cum0 = excl + l0, cum1 = inc;
      // total is cum at the last real row itself, so that its weight is
      // exactly 1: the scan's sum for row 63 groups the same terms otherwise
      total = __shfl_sync(0xffffffffu, (q - 1) & 1 ? cum1 : cum0, (q - 1) >> 1);
      store2(cum + 2 * lane, cum0, cum1);
      store2(wt + 2 * lane, exp2_neg(total - cum0) * d0, exp2_neg(total - cum1) * d1);
    }
    __syncwarp();
    const float ci0 = cum[i0], ci1 = cum[i1];

    // C B^T over the column blocks b <= sa, two n8 tiles each; then
    // y = exp2(cum_i) (C S) in the same pass over N
    float acc_cb[kWarps][2][4], acc_y[kYTiles][4];
#pragma unroll
    for (int b = 0; b < kWarps; ++b)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_cb[b][nt][e] = 0.0f;
#pragma unroll
    for (int nt = 0; nt < kYTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_y[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const FragA fc = load_a<T, BS>(s_c + kSub * sa * BS + 16 * ks, lane);
#pragma unroll
      for (int b = 0; b < kWarps; ++b) {
        if (b > sa) continue;
        FragB fb[2];
        load_b_nk<T, BS>(fb, s_b + kSub * b * BS + 16 * ks, lane);
        mma_split<kExact, kExact>(acc_cb[b][0], fc, fb[0]);
        mma_split<kExact, kExact>(acc_cb[b][1], fc, fb[1]);
      }
#pragma unroll
      for (int nt = 0; nt < kYTiles; nt += 2) {
        FragB fs[2], fl[2];
        load_b_nk<__nv_bfloat16, SS>(fs, sth + 8 * nt * SS + 16 * ks, lane);
        load_b_nk<__nv_bfloat16, SS>(fl, stl + 8 * nt * SS + 16 * ks, lane);
#pragma unroll
        for (int q2 = 0; q2 < 2; ++q2) fs[q2].lo[0] = fl[q2].hi[0], fs[q2].lo[1] = fl[q2].hi[1];
        mma_split<kExact, false>(acc_y[nt], fc, fs[0]);
        mma_split<kExact, false>(acc_y[nt + 1], fc, fs[1]);
      }
    }
    {
      const float e0 = exp2_neg(ci0), e1 = exp2_neg(ci1);
#pragma unroll
      for (int nt = 0; nt < kYTiles; ++nt) {
        acc_y[nt][0] *= e0;
        acc_y[nt][1] *= e0;
        acc_y[nt][2] *= e1;
        acc_y[nt][3] *= e1;
      }
    }

    // then + (C B^T * exp2(cum_i - cum_j) * dt_j) x, one key sub-chunk at a
    // time: the accumulator's C layout is the A layout of this product
#pragma unroll
    for (int b = 0; b < kWarps; ++b) {
      if (b > sa) continue;
      float2 sc[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = kSub * b + 8 * nt + 2 * t;  // columns j, j + 1
        const float2 cj = load2(cum + j), dj = load2(s_dt + j);
        const float* v = acc_cb[b][nt];
        const float w00 = b < sa || j <= i0 ? exp2_neg(ci0 - cj.x) * dj.x : 0.0f;
        const float w01 = b < sa || j + 1 <= i0 ? exp2_neg(ci0 - cj.y) * dj.y : 0.0f;
        const float w10 = b < sa || j <= i1 ? exp2_neg(ci1 - cj.x) * dj.x : 0.0f;
        const float w11 = b < sa || j + 1 <= i1 ? exp2_neg(ci1 - cj.y) * dj.y : 0.0f;
        sc[2 * nt] = make_float2(v[0] * w00, v[1] * w01);
        sc[2 * nt + 1] = make_float2(v[2] * w10, v[3] * w11);
      }
      FragA fa;
      fa.set(sc);
#pragma unroll
      for (int nt = 0; nt < kYTiles; nt += 2) {
        FragB fb[2];
        load_b_kn<T, XS>(fb, s_x + kSub * b * XS + 8 * nt, lane);
        mma_split<false, kExact>(acc_y[nt], fa, fb[0]);
        mma_split<false, kExact>(acc_y[nt + 1], fa, fb[1]);
      }
    }

    T* yrow0 = y + ((row0 + c0 + i0) * h + hi) * static_cast<size_t>(p) + p0;
    T* yrow1 = yrow0 + static_cast<size_t>(8) * h * p;
#pragma unroll
    for (int nt = 0; nt < kYTiles; ++nt) {
      const int col = 8 * nt + 2 * t;
      if (col >= nv) continue;  // nv is a multiple of 16
      if (i0 < q) store2(yrow0 + col, acc_y[nt][0], acc_y[nt][1]);
      if (i1 < q) store2(yrow1 + col, acc_y[nt][2], acc_y[nt][3]);
    }

    // S = exp2(total) S + (exp2(total - cum_j) dt_j B_j)^T x on this warp's units
    const float et = exp2_neg(total);
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
      for (int nt = 0; nt < 2 * kNP; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_s[mi][nt][e] *= et;
#pragma unroll
    for (int js = 0; js < kChunk / 16; ++js) {
      const float2 wl = load2(wt + 16 * js + 2 * t), wh = load2(wt + 16 * js + 2 * t + 8);
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi) {
        const FragA fa = load_a_trans_scaled<T, BS>(s_b + 16 * js * BS + 16 * (m0 + mi), wl, wh, lane);
#pragma unroll
        for (int np = 0; np < kNP; ++np) {
          FragB fb[2];
          load_b_kn<T, XS>(fb, s_x + 16 * js * XS + 16 * (np0 + np), lane);
          mma_split<false, kExact>(acc_s[mi][2 * np], fa, fb[0]);
          mma_split<false, kExact>(acc_s[mi][2 * np + 1], fa, fb[1]);
        }
      }
    }
    // its bf16 hi/lo copy for the next chunk: per unit the matrices (n 0-7,
    // p 0-7), (n 8-15, p 0-7), (n 0-7, p 8-15), (n 8-15, p 8-15) of the
    // accumulator, stored transposed into [p][n]
    {
      __nv_bfloat16* nh = s_st + ((c + 1) & 1) * 2 * kPTile * SS;
      __nv_bfloat16* nl = nh + kPTile * SS;
      const int mat = lane >> 3;
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
        for (int np = 0; np < kNP; ++np) {
          uint32_t rh[4], rl[4];
#pragma unroll
          for (int q2 = 0; q2 < 4; ++q2) {
            const float* v = acc_s[mi][2 * np + (q2 >> 1)];
            split(v[2 * (q2 & 1)], v[2 * (q2 & 1) + 1], rh[q2], rl[q2]);
          }
          const int idx = (16 * (np0 + np) + 8 * (mat >> 1) + (lane & 7)) * SS + 16 * (m0 + mi) + 8 * (mat & 1);
          stsm_x4_trans(nh + idx, rh);
          stsm_x4_trans(nl + idx, rl);
        }
    }
  }

  float* out = state + static_cast<size_t>(bh) * n * p + p0;
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi) {
    const int nr = 16 * (m0 + mi) + g;  // channels nr, nr + 8
#pragma unroll
    for (int nt = 0; nt < 2 * kNP; ++nt) {
      const int col = 16 * np0 + 8 * nt + 2 * t;
      if (col >= nv) continue;
      if (nr < n) store2(out + static_cast<size_t>(nr) * p + col, acc_s[mi][nt][0], acc_s[mi][nt][1]);
      if (nr + 8 < n) store2(out + static_cast<size_t>(nr + 8) * p + col, acc_s[mi][nt][2], acc_s[mi][nt][3]);
    }
  }
}

// Runs the instance for (dtype, N padded); with per_sm set, reports how many
// of its blocks one SM holds and the grid's size instead.
template <typename T, int NP>
cudaError_t run(const void* x, const float* dt, const float* a, const void* bm, const void* cm,
                void* y, float* state, int bsz, int l, int h, int p, int n, cudaStream_t stream,
                int* per_sm, int* blocks) {
  const int smem = Layout<T, NP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = bsz * h * ((p + kPTile - 1) / kPTile);
  if (per_sm) {
    *blocks = grid;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, ssd_kernel<T, NP>, kThreads, smem);
  }
  ssd_kernel<T, NP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), state, l, h, p, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_n(const void* x, const float* dt, const float* a, const void* bm, const void* cm,
                  void* y, float* state, int bsz, int l, int h, int p, int n, cudaStream_t stream,
                  int* per_sm, int* blocks) {
  if (n <= 16) return run<T, 16>(x, dt, a, bm, cm, y, state, bsz, l, h, p, n, stream, per_sm, blocks);
  if (n <= 32) return run<T, 32>(x, dt, a, bm, cm, y, state, bsz, l, h, p, n, stream, per_sm, blocks);
  if (n <= 64) return run<T, 64>(x, dt, a, bm, cm, y, state, bsz, l, h, p, n, stream, per_sm, blocks);
  return run<T, kMaxDim>(x, dt, a, bm, cm, y, state, bsz, l, h, p, n, stream, per_sm, blocks);
}

int dispatch(const void* x, const void* dt, const void* a, const void* bm, const void* cm, void* y,
             void* state, int bsz, int l, int h, int p, int n, int bf16, void* stream, int* per_sm,
             int* blocks) {
  if (p % 16 || n % 16 || p < 16 || n < 16 || p > kMaxDim || n > kMaxDim) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* st = static_cast<float*>(state);
  if (bf16) {
    return run_n<__nv_bfloat16>(x, dtf, af, bm, cm, y, st, bsz, l, h, p, n, s, per_sm, blocks);
  }
  return run_n<float>(x, dtf, af, bm, cm, y, st, bsz, l, h, p, n, s, per_sm, blocks);
}

}  // namespace

// bf16 != 0: x, B, C and y are bf16, else fp32; dt, a and the state are fp32.
// N and P are multiples of 16 up to 128; x, B, C and dt start 16-byte
// aligned.  Returns cudaGetLastError().
extern "C" int ssd_launch(const void* x, const void* dt, const void* a, const void* bm,
                          const void* cm, void* y, void* state, int bsz, int l, int h, int p,
                          int n, int bf16, void* stream) {
  return dispatch(x, dt, a, bm, cm, y, state, bsz, l, h, p, n, bf16, stream, nullptr, nullptr);
}

// For x of shape (B, ., H, P), B and C of width N, and the dtype: the blocks
// of the kernel's instance one SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// into *per_sm and the blocks of its grid into *blocks.
extern "C" int ssd_occupancy(int bsz, int h, int p, int n, int bf16, int* per_sm, int* blocks) {
  return dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, bsz, 1, h, p, n, bf16,
                  nullptr, per_sm, blocks);
}
