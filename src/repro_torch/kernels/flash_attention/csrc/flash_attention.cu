// Flash attention forward for Hopper (sm_90a): online-softmax attention over
// (B, H, L, D) q/k/v with causal and sliding-window masks, logit soft-cap,
// GQA and a query offset.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::_fa_kernel (launched by
// flash_attention_fwd).  Its plain PyTorch version is
// src/repro_torch/kernels/flash_attention/ref.py::mha_blocked.  Both routes
// keep the running max, denominator and accumulator in fp32.
//
// What bounds it on the card: operations.  At the zamba2-1.2b serving shape
// (B = 4, L = 4096, 32 heads, D = 64, causal) it does 2.749e11 flop on
// 2.68e8 bytes, about 1000 flop per byte, far above the card's balance point
// (~295 flop/byte against the bf16 tensor cores): 0.278 ms at 989 TFLOP/s
// bf16, against 0.080 ms for the bytes.  So the two products have to run on
// the tensor cores.  The launcher routes by dtype, one kernel each:
//
// * bf16 (the serving path): flash_attention_bf16_kernel on Hopper's
//   warpgroup MMA (wgmma, bf16 in, fp32 accumulate).  A block of two
//   warpgroups owns 128 query rows, 64 per warpgroup.  TMA brings the q
//   tile once and K/V tiles of 64 rows (32 at D = 256) into a two-stage
//   ring, each stage signalled by an mbarrier, so tile t + 1 loads while
//   tile t computes; the 3-d tensor maps zero-fill rows past lq and lk, and
//   write each tile swizzled at its row width (32, 64 or 128 bytes), the
//   layout wgmma reads through its descriptors.  S = Q K^T runs from shared
//   memory into registers; the scores stay there: the fp32 accumulator of
//   each warp's 16 rows is, packed to bf16, the register A operand of P V,
//   with V read from shared memory as a transposed (N-major) B operand.
//   One rounding of P to bf16 is off by up to 2^-9 of each entry, which
//   moves the output by more than one bf16 step against mha_blocked on
//   small causal rows (tests/test_torch_flash_attention.py shows it), so P
//   is split into a bf16 high part and a bf16 remainder and P V takes two
//   MMAs (1.5x the tensor-core work of one rounding) to agree with the fp32
//   sum.  The row max and sum are 4-lane shuffles over the quad that shares
//   a row; scale * log2(e) is folded into one FFMA before ex2.approx.  Only
//   tiles that cross the causal diagonal, the window edge or lk build
//   per-element masks; masked entries give p = 0 explicitly; a warpgroup
//   with no live row in a tile skips it.  The grid launches the heaviest
//   causal q tiles first.
// * fp32: flash_attention_fp32_kernel, the first design on the CUDA cores
//   (fp32 FMAs, expf, IEEE division).  A tensor-core product of fp32 inputs
//   would be TF32 (about three decimal digits), too coarse for the fp32
//   tolerance of 2e-5 that the JAX package holds its kernel to.
//
// Both skip kv tiles with no live (row, col) pair with the geometry of
// _fa_kernel (causal: col_min <= last row; window: col_max > first row -
// window), so a causal prefill does about half the tiles.  D is a template
// parameter (16, 32, 64, 128, 256).
//
// Measured at the serving shape (bf16, causal) on an NVIDIA H100 80GB HBM3
// at 700 W by chip_smoke.py phase 12: this design 1.0210 ms (269 TFLOP/s,
// 0.27 of the bound), SDPA 0.6390 ms in the same run; the first design (fp32
// CUDA-core arithmetic for bf16 too) took 11.4352 ms.  compare_flash.py, in
// one run: this design 1.0167 / 1.0087 ms, an mma.sync.m16n8k16 design
// (8 warps, ldmatrix fragments, cp.async double buffering, the same P
// split) 1.3774 / 1.4017 ms.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// fp32: CUDA cores

constexpr int kBlockQ = 64;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRowsPerThread = kBlockQ / 16;

template <int D>
struct Tile {
  static constexpr int kBlockK = D == 256 ? 32 : 64;
  static constexpr int kQStride = D + 1;  // padded rows: column reads hit distinct banks
  static constexpr int kPStride = kBlockK + 1;
  static constexpr int kSmemFloats =
      kBlockQ * kQStride + kBlockK * kQStride + kBlockK * D + kBlockQ * kPStride;
};

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One block per (64-row q tile, q head, batch); K/V tiles staged in shared
// memory; 256 threads as 16 x 16, thread (ty, tx) owns q rows 4ty..4ty+3,
// score columns tx + 16j and output columns tx + 16j.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_fp32_kernel(
    const float* __restrict__ q,  // (B, Hq, Lq, D)
    const float* __restrict__ k,  // (B, Hkv, Lk, D)
    const float* __restrict__ v,  // (B, Hkv, Lk, D)
    float* __restrict__ o,        // (B, Hq, Lq, D)
    int hq, int hkv, int lq, int lk, int causal, int window, float softcap, float scale,
    int q_offset) {
  using TL = Tile<D>;
  constexpr int BK = TL::kBlockK;
  constexpr int CJ = BK / 16;  // score columns per thread
  constexpr int DJ = D / 16;   // output columns per thread
  constexpr int QS = TL::kQStride;
  constexpr int PS = TL::kPStride;
  extern __shared__ float smem[];
  float* qs = smem;              // [kBlockQ][QS]
  float* ks = qs + kBlockQ * QS;  // [BK][QS]
  float* vs = ks + BK * QS;       // [BK][D]
  float* ps = vs + BK * D;        // [kBlockQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = blockIdx.x * kBlockQ;
  const float* qg = q + (static_cast<size_t>(b) * hq + h) * lq * D;
  const float* kg = k + (static_cast<size_t>(b) * hkv + hk) * lk * D;
  const float* vg = v + (static_cast<size_t>(b) * hkv + hk) * lk * D;
  float* og = o + (static_cast<size_t>(b) * hq + h) * lq * D;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    qs[r * QS + d] = q0 + r < lq ? qg[static_cast<size_t>(q0 + r) * D + d] : 0.0f;
  }

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][DJ];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int dj = 0; dj < DJ; ++dj) acc[i][dj] = 0.0f;
  }

  // absolute kv positions of this tile's first and last real query rows
  const int row_min = q0 + q_offset;
  const int row_max = min(q0 + kBlockQ, lq) - 1 + q_offset;
  const int n_tiles = (lk + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * BK;
    bool live = causal ? c0 <= min(row_max, lk - 1) : true;
    if (window > 0) live = live && (c0 + BK - 1 > row_min - window);
    if (!live) continue;  // the same for every thread of the block

    __syncthreads();  // the previous tile's reads of ks, vs, ps are done
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const bool in = c0 + r < lk;
      const size_t g = static_cast<size_t>(c0 + r) * D + d;
      ks[r * QS + d] = in ? kg[g] : 0.0f;
      vs[r * D + d] = in ? vg[g] : 0.0f;
    }
    __syncthreads();

    float s[kRowsPerThread][CJ];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRowsPerThread], kv[CJ];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = qs[(ty * kRowsPerThread + i) * QS + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty * kRowsPerThread + i;
      const int row = q0 + r + q_offset;
      bool ok[CJ];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = c0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        ok[j] = col < lk && (!causal || col <= row) && (window <= 0 || col > row - window);
        s[i][j] = x;
        if (ok[j]) mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        ps[r * PS + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int dj = 0; dj < DJ; ++dj) acc[i][dj] *= alpha;
    }
    __syncthreads();  // ps is complete

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[kRowsPerThread], vv[DJ];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) pv[i] = ps[(ty * kRowsPerThread + i) * PS + c];
#pragma unroll
      for (int dj = 0; dj < DJ; ++dj) vv[dj] = vs[c * D + tx + 16 * dj];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int dj = 0; dj < DJ; ++dj) acc[i][dj] = fmaf(pv[i], vv[dj], acc[i][dj]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = q0 + ty * kRowsPerThread + i;
    if (r >= lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dj = 0; dj < DJ; ++dj) {
      og[static_cast<size_t>(r) * D + tx + 16 * dj] = acc[i][dj] / denom;
    }
  }
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o, int b, int hq,
                        int hkv, int lq, int lk, int causal, int window, float softcap,
                        float scale, int q_offset, cudaStream_t stream) {
  const int smem = Tile<D>::kSmemFloats * static_cast<int>(sizeof(float));
  auto kernel = flash_attention_fp32_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, hq, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), hq, hkv, lq, lk, causal, window, softcap, scale, q_offset);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync.m16n8k16)

namespace tc {

constexpr int kWarpGroups = 2;
constexpr int kThreads = 128 * kWarpGroups;
constexpr int kBlockQ = 64 * kWarpGroups;  // each warpgroup owns 64 query rows, 16 per warp
constexpr float kLog2e = 1.4426950408889634f;

// Tiles live in shared memory as TMA writes them: [D / kCols][rows][kCols]
// bf16, each row kRowBytes (32, 64 or 128) wide and swizzled at that width,
// which is also the layout wgmma reads through its descriptors.
template <int D>
struct Tile {
  static constexpr int kBlockK = D == 256 ? 32 : 64;
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = 2 * kCols;
  static constexpr int kQBytes = kBlockQ * D * 2;
  static constexpr int kKVBytes = kBlockK * D * 2;  // one K or V tile
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;  // wgmma swizzle
  // 1024 bytes of alignment slack, q, K and V in two stages each, 3 mbarriers
  static constexpr int kSmemBytes = 1024 + kQBytes + 4 * kKVBytes + 3 * 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of a 3-d tensor map (x = column, y = row, z = batch * head) into
// shared memory; completion counts against `bar`'s expected bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int x,
                                         int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// a wgmma shared-memory operand: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x N, fp32) (+)= A (64 x 16, shared, K-major) * B (16 x N, shared, K-major)
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate);
// d (64 x N, fp32) += A (64 x 16, registers) * B (16 x N, shared, N-major)
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

// the accumulator operands d[i .. i + 7] of a wgmma
#define FA_ACC8(i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : FA_ACC8(0), FA_ACC8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : FA_ACC8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : FA_ACC8(0), FA_ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef FA_ACC8

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) as a bf16 pair hi plus a bf16 pair lo of the remainder: hi + lo
// keeps about 16 bits of each value's mantissa
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);  // .x (x0) in the low half
  const float2 f = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - f.x, x1 - f.y));
}

// 2^x on the special-function unit (about 2 ulp; results below 2^-126 flush
// to 0, which no p that reaches a bf16 output can tell apart)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one (16 x N/4*8) score tile of a warp.  s holds scores
// in the m16n8 C layout, n-tile nt in s[4 nt .. 4 nt + 3]; times `mul` they
// are in the log2 domain.  This lane's rows are `row` and `row + 8`
// (absolute kv positions), its columns col + 8 nt + {0, 1}.  On return s
// holds p (0 where masked), m the new row max (log2 domain), l this lane's
// share of the row sum, alpha the factor for the old accumulator.
template <bool kEdge, int N>
__device__ __forceinline__ void online_softmax(float (&s)[N], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int row, int col, int lk,
                                               int causal, int window, float mul) {
  static_assert(N <= 32, "one live bit per score");
  uint32_t live = 0xffffffffu;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (kEdge) {
      const int r = row + ((i >> 1) & 1) * 8, c = col + (i >> 2) * 8 + (i & 1);
      if (!(c < lk && (!causal || c <= r) && (window <= 0 || c > r - window))) {
        s[i] = kNegInf;
        live &= ~(1u << i);
      }
    }
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * mul);  // never below kNegInf
    alpha[i] = exp2_approx(m[i] - m_new);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float p = exp2_approx(fmaf(s[i], mul, -m[(i >> 1) & 1]));
    if (kEdge && !((live >> i) & 1u)) p = 0.0f;
    s[i] = p;
    l[(i >> 1) & 1] += p;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_bf16_kernel(
    const __grid_constant__ CUtensorMap map_q,  // (B * Hq, Lq, D)
    const __grid_constant__ CUtensorMap map_k,  // (B * Hkv, Lk, D)
    const __grid_constant__ CUtensorMap map_v,  // (B * Hkv, Lk, D)
    __nv_bfloat16* __restrict__ o,              // (B, Hq, Lq, D)
    int hq, int hkv, int lq, int lk, int causal, int window, float softcap, float scale,
    int q_offset) {
  using TL = Tile<D>;
  constexpr int BQ = kBlockQ;
  constexpr int BK = TL::kBlockK;
  constexpr int KC = TL::kCols;
  constexpr int RB = TL::kRowBytes;
  constexpr int NB = D / KC;  // column blocks
  constexpr int NSR = BK / 2; // S registers a thread holds (64 x BK over 128 threads)
  constexpr int NAR = KC / 2; // accumulator registers per column block
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qs = (smem_addr(smem_raw) + 1023) & ~1023u;  // [NB][BQ][KC]
  const uint32_t ks = qs + TL::kQBytes;                      // [2][NB][BK][KC]
  const uint32_t vs = ks + 2 * TL::kKVBytes;                 // [2][NB][BK][KC]
  const uint32_t bars = vs + 2 * TL::kKVBytes;               // q, then one per K/V stage

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // the heaviest causal tiles first
  const int zq = b * hq + h, zk = b * hkv + h / (hq / hkv);

  // the live kv tiles [t_begin, t_end): _fa_kernel's test (as in the fp32
  // kernel) solved for the tile index
  const int row_min = q0 + q_offset;
  const int row_max = min(q0 + BQ, lq) - 1 + q_offset;
  const int n_tiles = (lk + BK - 1) / BK;
  int t_end = n_tiles;
  if (causal) {
    const int last = min(row_max, lk - 1);
    t_end = last < 0 ? 0 : min(n_tiles, last / BK + 1);
  }
  int t_begin = 0;
  if (window > 0) {
    const int y = row_min - window - BK + 1;  // live: t * BK > y
    if (y >= 0) t_begin = y / BK + 1;
  }

  const int wg_row_min = q0 + wg * 64 + q_offset;
  const int warp_row_min = q0 + warp * 16 + q_offset;
  const int row = warp_row_min + (lane >> 2);  // and row + 8
  const bool use_cap = softcap > 0.0f;
  const float mul = use_cap ? 1.0f : scale * kLog2e;
  const float cap_in = scale / softcap, cap_out = softcap * kLog2e;

  float acc[NB][NAR];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < NAR; ++i) acc[j][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (t_begin < t_end) {  // the same for every thread of the block
    if (tid == 0) {
      mbar_expect_tx(bars, TL::kQBytes);
      for (int j = 0; j < NB; ++j) tma_load(qs + j * BQ * RB, &map_q, bars, j * KC, q0, zq);
      mbar_expect_tx(bars + 8, 2 * TL::kKVBytes);
      for (int j = 0; j < NB; ++j) {
        tma_load(ks + j * BK * RB, &map_k, bars + 8, j * KC, t_begin * BK, zk);
        tma_load(vs + j * BK * RB, &map_v, bars + 8, j * KC, t_begin * BK, zk);
      }
    }
    mbar_wait(bars, 0);
    __syncwarp();
    const uint32_t q_wg = qs + wg * 64 * RB;

    for (int t = t_begin; t < t_end; ++t) {
      const int it = t - t_begin, stage = it & 1;
      if (tid == 0 && t + 1 < t_end) {  // the other stage was released by the last barrier
        const uint32_t bar = bars + 8 * (2 - stage);
        const uint32_t off = (stage ^ 1) * TL::kKVBytes;
        mbar_expect_tx(bar, 2 * TL::kKVBytes);
        for (int j = 0; j < NB; ++j) {
          tma_load(ks + off + j * BK * RB, &map_k, bar, j * KC, (t + 1) * BK, zk);
          tma_load(vs + off + j * BK * RB, &map_v, bar, j * KC, (t + 1) * BK, zk);
        }
      }
      mbar_wait(bars + 8 * (1 + stage), (it >> 1) & 1);
      __syncwarp();
      const uint32_t kt = ks + stage * TL::kKVBytes, vt = vs + stage * TL::kKVBytes;
      const int c0 = t * BK;
      // this warpgroup's rows see a live column in this tile
      const bool wg_live = (!causal || c0 <= wg_row_min + 63) &&
                           (window <= 0 || c0 + BK - 1 > wg_row_min - window);
      if (wg_live) {
        float s[NSR];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          // K-major operands: 8-row groups 8 * RB apart (the leading offset
          // is unused when swizzled); k-steps are 32-byte steps along a row
          const uint32_t off = (kk * 16 % KC) * 2;
          const int blk = kk * 16 / KC;
          const uint64_t da = make_desc(q_wg + blk * BQ * RB + off, 16, 8 * RB, TL::kLayout);
          const uint64_t db = make_desc(kt + blk * BK * RB + off, 16, 8 * RB, TL::kLayout);
          wgmma_ss<BK>(s, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();

        if (use_cap) {
#pragma unroll
          for (int i = 0; i < NSR; ++i) s[i] = cap_out * tanhf(s[i] * cap_in);
        }
        const bool edge = c0 + BK > lk || (causal && c0 + BK - 1 > warp_row_min) ||
                          (window > 0 && c0 <= warp_row_min + 15 - window);
        float alpha[2];
        const int col = c0 + 2 * (lane & 3);
        if (edge) {
          online_softmax<true>(s, m, l, alpha, row, col, lk, causal, window, mul);
        } else {
          online_softmax<false>(s, m, l, alpha, row, col, lk, causal, window, mul);
        }
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int i = 0; i < NAR; ++i) acc[j][i] *= alpha[(i >> 1) & 1];

        // P V: the C fragments of n-tiles 2kj and 2kj + 1 are the A fragment
        // of k-step kj; P enters as a bf16 high part and a bf16 remainder
        wgmma_fence();
#pragma unroll
        for (int kj = 0; kj < BK / 16; ++kj) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            split_bf16(s[8 * kj + 2 * i], s[8 * kj + 2 * i + 1], hi[i], lo[i]);
          }
#pragma unroll
          for (int j = 0; j < NB; ++j) {  // V, N-major: 16 kv rows = two 8-row groups
            const uint64_t db =
                make_desc(vt + (j * BK + kj * 16) * RB, 8 * RB, 8 * RB, TL::kLayout);
            wgmma_rs<KC>(acc[j], hi, db);
            wgmma_rs<KC>(acc[j], lo, db);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
      }
      __syncthreads();  // both warpgroups are done with this stage before it is refilled
    }
  }

  // epilogue: the row sums over the quad, then o = acc / l as bf16 pairs
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
  __nv_bfloat16* og = o + (static_cast<size_t>(b) * hq + h) * lq * D;
  const int r0 = q0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qr = r0 + 8 * half;
    if (qr >= lq) continue;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
        const int c = j * KC + n * 8 + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(og + static_cast<size_t>(qr) * D + c) =
            __floats2bfloat162_rn(acc[j][4 * n + 2 * half] / den[half],
                                  acc[j][4 * n + 2 * half + 1] / den[half]);
      }
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, looked up at run time (no link to libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// (depth, rows, d) bf16 as a 3-d tensor map of (min(d, 64), box_rows, 1)
// boxes, swizzled at the box row's width; rows past `rows` read as zeros
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int rows, int depth, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(Tile<D>::kCols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = Tile<D>::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : Tile<D>::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int b, int hq,
                        int hkv, int lq, int lk, int causal, int window, float softcap,
                        float scale, int q_offset, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  if (!make_map<D>(&map_q, q, lq, b * hq, kBlockQ) ||
      !make_map<D>(&map_k, k, lk, b * hkv, Tile<D>::kBlockK) ||
      !make_map<D>(&map_v, v, lk, b * hkv, Tile<D>::kBlockK)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = Tile<D>::kSmemBytes;
  auto kernel = flash_attention_bf16_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(hq, b, (lq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o),
                                           hq, hkv, lq, lk, causal, window, softcap, scale,
                                           q_offset);
  return cudaGetLastError();
}

}  // namespace tc

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv,
                   int lq, int lk, int bf16, int causal, int window, float softcap, float scale,
                   int q_offset, cudaStream_t stream) {
  return bf16 ? tc::launch_bf16<D>(q, k, v, o, b, hq, hkv, lq, lk, causal, window, softcap, scale,
                               q_offset, stream)
              : launch_fp32<D>(q, k, v, o, b, hq, hkv, lq, lk, causal, window, softcap, scale,
                               q_offset, stream);
}

}  // namespace

// window <= 0: no sliding window; softcap <= 0: no soft-cap.  bf16 != 0: q, k,
// v and o are bf16 (tensor-core kernel; pointers 16-byte aligned), else fp32
// (CUDA-core kernel).  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int b, int hq, int hkv, int lq, int lk, int d, int bf16,
                                      int causal, int window, float softcap, float scale,
                                      int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<16>(q, k, v, o, b, hq, hkv, lq, lk, bf16, causal, window, softcap, scale,
                        q_offset, s);
    case 32:
      return launch<32>(q, k, v, o, b, hq, hkv, lq, lk, bf16, causal, window, softcap, scale,
                        q_offset, s);
    case 64:
      return launch<64>(q, k, v, o, b, hq, hkv, lq, lk, bf16, causal, window, softcap, scale,
                        q_offset, s);
    case 128:
      return launch<128>(q, k, v, o, b, hq, hkv, lq, lk, bf16, causal, window, softcap, scale,
                         q_offset, s);
    case 256:
      return launch<256>(q, k, v, o, b, hq, hkv, lq, lk, bf16, causal, window, softcap, scale,
                         q_offset, s);
    default:
      return cudaErrorInvalidValue;
  }
}
