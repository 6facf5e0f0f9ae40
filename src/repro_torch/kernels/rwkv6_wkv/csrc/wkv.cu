// RWKV6 ("Finch") WKV core for Hopper (sm_90a), chunked form with
// per-channel data-dependent decay, its products on the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_wkv/kernel.py::_wkv_kernel
// (launched by wkv_fwd).  Its plain PyTorch version is
// src/repro_torch/kernels/rwkv6_wkv/ref.py::wkv_chunked.  Per (batch, head),
// over chunks of 64 rows, with lw = log2(clip(w, 1e-20, 1)), cw its
// inclusive cumsum inside the chunk, cs = cw of the row before (0 at the
// first row) and total = cw[last]:
//   score  s_ij = sum_k r_ik k_jk exp2(cs_ik - cw_jk)  (j < i),  s_ii = sum_k r_ik u_k k_ik
//   y_i   = sum_j s_ij v_j + (r_i * exp2(cs_i)) S
//   S     = exp2(total) * S + sum_j (k_j * exp2(total - cw_j))^T v_j
// and the final S is written in fp32.
//
// What bounds it on the card: bytes, counting each input read once and each
// output written once (about 5.06e8 at the rwkv6-3b serving shape B = 4,
// L = 4096, H = 40, K = V = 64, r/k/v bf16, w fp32: 0.151 ms at 3.35 TB/s,
// against 2e10 operations).  What this design does about the rest:
//   * Sub-chunk factoring.  The chunk is four sub-chunks of 16 rows.  For
//     query sub-chunk a, key sub-chunk b < a and n_b = cw at b's last row,
//     exp2(cs_i - cw_j) = exp2(cs_i - n_b) * exp2(n_b - cw_j), both
//     exponents <= 0 (cumsums of log decays only fall), so nothing
//     overflows under the strong decay w = 1e-12, where the TPU kernel's
//     reason for avoiding exp(+cum) holds.  The six off-diagonal 16 x 16
//     score blocks become products (r * e)(k * e)^T; only the four diagonal
//     blocks take one exp2 per term, on the CUDA cores, and carry the bonus
//     r u k on their diagonal.  Each exp2 is one ex2.approx (relative error
//     about 2^-22): exp2f's range handling took 0.25 of 1.52 ms on an H100.
//   * Tensor cores.  The off-diagonal score, score * v, (r e^cs) * S and
//     (k e^(total - cw))^T * v run as mma.sync.m16n8k16 bf16 -> fp32.  Each
//     fp32 operand is split into a bf16 high part and a bf16 remainder and
//     the product taken as hi*hi + hi*lo + lo*hi: one bf16 rounding of any
//     operand exceeds the output tolerance (tests/test_torch_rwkv6_wkv.py
//     emulates both).  v is exact in bf16 on the bf16 route, so its
//     remainder is skipped there and its fragments come straight from
//     shared memory by ldmatrix.trans.  The fp32 route runs the same code.
//   * One wave.  A block is 4 warps, one per query sub-chunk, and about
//     108 KB of shared memory at K = 64 (bf16): two blocks fit an SM, so the
//     160 blocks of the serving shape are resident at once on 132 SMs.  The
//     carried state stays fp32 in registers, as the accumulator of the
//     state product; a bf16 hi/lo copy in shared memory feeds the next
//     chunk's inter-chunk product.
//   * The next chunk's r, k and v arrive by cp.async into a second buffer
//     while this chunk is computed; w's buffer is refilled as soon as the
//     cumsum has read it.
// What holds it back now (compare_flash.py --kernel wkv, variants with one
// part removed): latency, not a unit's throughput.  Most SMs hold one block,
// one warp per scheduler, and the query sub-chunk a's warp does a
// off-diagonal blocks.  Evening the warps out measured slower on an H100:
// two of those blocks moved to the lighter warps through shared memory (one
// more barrier), or state tiles moved from the last warp to the first; so
// did the diagonal block's lower-left quadrant as an MMA.
// One block per (batch, head, 64-column tile of V) walks its chunks in
// order (the TPU's sequential grid axis becomes this loop); nothing carries
// between blocks.  r, k, v and w are read in their own dtype and the
// model's (B, L, H, .) layout.  K is padded to the next of 16, 32, 64, 128
// with zero channels (w = 1) and V to the tile with zero columns; a ragged
// last chunk loads r = k = v = 0 and w = 1 past L, the JAX wrapper's
// identity padding, so the final state is the unpadded one.  K and V are
// multiples of 16 up to 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kChunk = 64;  // ops.CHUNK on the Python side
constexpr int kSub = 16;  // rows of a sub-chunk: one warp's query rows
constexpr int kWarps = kChunk / kSub;
constexpr int kThreads = 32 * kWarps;
constexpr int kVTile = 64;  // V columns per block
constexpr int kMaxDim = 128;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
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

// (a, b) -> bf16 high parts and bf16 remainders, a in the low half
__device__ __forceinline__ void split(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// A 16 x 16 bf16 operand of mma.m16n8k16 in its register layout (row-major:
// thread (g, t) holds rows g, g + 8 and columns 2t, 2t + 1, 2t + 8, 2t + 9),
// as high parts and remainders
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

// c += a b with both operands split: hi*hi + hi*lo + lo*hi; b_exact: b's
// remainder is zero
template <bool b_exact>
__device__ __forceinline__ void mma_split(float (&c)[4], const FragA& a, const FragB& b) {
  mma(c, a.hi, b.hi);
  mma(c, a.lo, b.hi);
  if (!b_exact) mma(c, a.hi, b.lo);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Shared-memory layout of one instance; every [row][channel] array has rows
// of KP + 8 elements, so the fragment loads of a warp hit distinct banks.
template <typename T, typename TW, int KP>
struct Layout {
  static constexpr int kRS = KP + 8;                         // r, k, cw, the state copy
  static constexpr int kVS = kVTile + 16 / int(sizeof(T));   // v
  static constexpr int kWS = KP + 16 / int(sizeof(TW));      // w
  static constexpr int kStageBytes = (2 * kChunk * kRS + kChunk * kVS) * int(sizeof(T));
  static constexpr int kWBytes = kChunk * kWS * int(sizeof(TW));
  static constexpr int kCwBytes = (kChunk + 1) * kRS * 4;    // row 0: zeros, row i + 1: cw of row i
  static constexpr int kStateBytes = 2 * kVTile * kRS * 2;   // bf16 hi and lo, [V][K]
  static constexpr int kFixedBytes = kWBytes + kCwBytes + kStateBytes + KP * 4;
  static constexpr int kStages = kFixedBytes + 2 * kStageBytes <= kSmemLimit ? 2 : 1;
  static constexpr int kBytes = kFixedBytes + kStages * kStageBytes;
};

template <typename T, typename TW, int KP>
__global__ void __launch_bounds__(kThreads, 2) wkv_kernel(
    const T* __restrict__ r,     // (B, L, H, K)
    const T* __restrict__ k,     // (B, L, H, K)
    const T* __restrict__ v,     // (B, L, H, V)
    const TW* __restrict__ w,    // (B, L, H, K) decay in (0, 1)
    const float* __restrict__ u,  // (H, K) bonus
    T* __restrict__ y,           // (B, L, H, V)
    float* __restrict__ state,   // (B, H, K, V)
    int l, int h, int kd, int vd) {
  using L = Layout<T, TW, KP>;
  constexpr int RS = L::kRS, VS = L::kVS, WS = L::kWS;
  constexpr int kStages = L::kStages;
  constexpr bool kVExact = std::is_same<T, __nv_bfloat16>::value;  // v's remainder is zero
  constexpr int kKSteps = KP / 16;
  // the state's (K x V tile) accumulator tiles of this warp: m16 tiles of K
  // rows by n8 tiles of V columns
  constexpr int kStateM = KP >= 64 ? KP / 64 : 1;
  constexpr int kStateN = KP >= 64 ? 8 : KP / 8;
  // y's columns in one pass, or two where the fp32 route at K = 128 would
  // otherwise run out of registers
  constexpr int kYParts = KP == kMaxDim && !kVExact ? 2 : 1;

  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  T* s_stage = reinterpret_cast<T*>(smem);  // per stage: r [Q][RS], k [Q][RS], v [Q][VS]
  unsigned char* fixed = smem + kStages * L::kStageBytes;
  TW* s_w = reinterpret_cast<TW*>(fixed);                               // [Q][WS]
  float* s_cw = reinterpret_cast<float*>(fixed + L::kWBytes);           // [Q + 1][RS]
  __nv_bfloat16* s_sth = reinterpret_cast<__nv_bfloat16*>(fixed + L::kWBytes + L::kCwBytes);
  __nv_bfloat16* s_stl = s_sth + kVTile * RS;                            // [V tile][RS] each
  float* s_u = reinterpret_cast<float*>(fixed + L::kWBytes + L::kCwBytes + L::kStateBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_vt = (vd + kVTile - 1) / kVTile;
  const int bh = blockIdx.x / n_vt;
  const int v0 = (blockIdx.x % n_vt) * kVTile;
  const int bi = bh / h;
  const int hi = bh % h;
  const int nv = min(kVTile, vd - v0);  // a multiple of 16
  const int n_chunks = (l + kChunk - 1) / kChunk;
  const size_t row_stride = static_cast<size_t>(h);  // (B, L, H, .): rows of one head are H apart

  // padding that cp.async never writes: channels kd..KP of r and k, columns
  // nv..64 of v, in every stage; row 0 of cw; the bonus
  for (int idx = tid; idx < kStages * L::kStageBytes / 2; idx += kThreads) {
    reinterpret_cast<uint16_t*>(s_stage)[idx] = 0;
  }
  for (int idx = tid; idx < RS; idx += kThreads) s_cw[idx] = 0.0f;
  for (int idx = tid; idx < KP; idx += kThreads) s_u[idx] = idx < kd ? u[hi * kd + idx] : 0.0f;
  __syncthreads();

  // one chunk's r, k, v into a stage, and its w; rows past L are zero-filled
  auto load_rkv = [&](int c, int stage) {
    T* s_r = s_stage + stage * (L::kStageBytes / int(sizeof(T)));
    T* s_k = s_r + kChunk * RS;
    T* s_v = s_k + kChunk * RS;
    constexpr int kPer = 16 / int(sizeof(T));  // elements per 16-byte copy
    const int k_pieces = kd / kPer, v_pieces = nv / kPer;
    for (int idx = tid; idx < kChunk * (2 * k_pieces + v_pieces); idx += kThreads) {
      const int row = idx / (2 * k_pieces + v_pieces);
      int p = idx % (2 * k_pieces + v_pieces);
      const int lrow = c * kChunk + row;
      const bool live = lrow < l;
      const size_t grow = (static_cast<size_t>(bi) * l + (live ? lrow : 0)) * row_stride + hi;
      if (p < 2 * k_pieces) {
        const T* src = (p < k_pieces ? r : k) + grow * kd;
        T* dst = (p < k_pieces ? s_r : s_k) + row * RS;
        p %= k_pieces;
        cp_async16(dst + p * kPer, src + p * kPer, live ? 16 : 0);
      } else {
        p -= 2 * k_pieces;
        cp_async16(s_v + row * VS + p * kPer, v + grow * vd + v0 + p * kPer, live ? 16 : 0);
      }
    }
  };
  auto load_w = [&](int c) {
    constexpr int kPer = 16 / int(sizeof(TW));
    const int pieces = kd / kPer;
    for (int idx = tid; idx < kChunk * pieces; idx += kThreads) {
      const int row = idx / pieces, p = idx % pieces;
      const int lrow = c * kChunk + row;
      const bool live = lrow < l;
      const size_t grow = (static_cast<size_t>(bi) * l + (live ? lrow : 0)) * row_stride + hi;
      cp_async16(s_w + row * WS + p * kPer, w + grow * kd + p * kPer, live ? 16 : 0);
    }
  };

  // this warp's state tiles, fp32, carried over the whole sequence
  const int st_m0 = KP >= 64 ? warp * kStateM : warp % (KP / 16);
  const int st_n0 = KP >= 64 ? 0 : (warp / (KP / 16)) * kStateN;
  float acc_s[kStateM][kStateN][4];
#pragma unroll
  for (int m = 0; m < kStateM; ++m)
#pragma unroll
    for (int n = 0; n < kStateN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_s[m][n][e] = 0.0f;
  for (int idx = tid; idx < 2 * kVTile * RS; idx += kThreads) {
    s_sth[idx] = __float2bfloat16_rn(0.0f);
  }

  load_rkv(0, 0);
  load_w(0);
  cp_async_commit();

  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * kChunk;
    const int q = min(kChunk, l - c0);  // real rows of this chunk
    const int stage = kStages == 2 ? (c & 1) : 0;
    if (kStages == 1 && c > 0) {
      __syncthreads();  // the previous chunk's reads of the stage are done
      load_rkv(c, 0);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();  // this chunk's inputs and the previous chunk's state copy are visible
    if (kStages == 2 && c + 1 < n_chunks) {
      load_rkv(c + 1, (c + 1) & 1);  // into the stage the previous chunk used
      cp_async_commit();
    }
    const T* s_r = s_stage + stage * (L::kStageBytes / int(sizeof(T)));
    const T* s_k = s_r + kChunk * RS;
    const T* s_v = s_k + kChunk * RS;

    // cw: inclusive cumsums of log2(clip(w)) down the chunk.  Each channel
    // has kTpc threads, each summing kRows consecutive rows in registers;
    // their offsets come from a shuffle scan.  Rows past L and channels past
    // K have w = 1.
    {
      constexpr int kTpc = kThreads / KP;
      constexpr int kRows = kChunk / kTpc;
      const int kc = tid / kTpc, part = tid % kTpc;
      float run[kRows];
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = part * kRows + i;
        const float lw = (row < q && kc < kd)
                             ? log2f(fminf(fmaxf(to_float(s_w[row * WS + kc]), 1e-20f), 1.0f))
                             : 0.0f;
        sum += lw;
        run[i] = sum;
      }
      float incl = sum;
#pragma unroll
      for (int off = 1; off < kTpc; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off, kTpc);
        if (part >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1, kTpc);
      if (part == 0) excl = 0.0f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) s_cw[(part * kRows + i + 1) * RS + kc] = excl + run[i];
    }
    __syncthreads();  // cw is complete; w's buffer is free
    if (c + 1 < n_chunks) {
      load_w(c + 1);
      cp_async_commit();
    }

    // ---- this warp's 16 query rows: score, y ----
    const int a = warp;
    const int i0 = kSub * a + g, i1 = i0 + 8;  // chunk rows of this thread's accumulator entries
    // score blocks (a, b) as two n8 tiles each: b < a in acc_sc, b = a in acc_dg
    float acc_sc[kWarps - 1][2][4], acc_dg[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_dg[nt][e] = 0.0f;
#pragma unroll
        for (int b = 0; b < kWarps - 1; ++b) acc_sc[b][nt][e] = 0.0f;
      }

    // diagonal block: one exp2 per term; entries (i0, 2t + 8), (i0, 2t + 9)
    // lie above the diagonal and stay 0
    {
      const int j0 = kSub * a + 2 * t;  // columns j0, j0 + 1, j0 + 8, j0 + 9
      const bool live0 = 2 * t < g, diag0 = 2 * t == g;
      const bool live1 = 2 * t + 1 < g, diag1 = 2 * t + 1 == g;
#pragma unroll 4
      for (int kc = 0; kc < KP; kc += 2) {
        const float2 ra = load2(s_r + i0 * RS + kc), rb = load2(s_r + i1 * RS + kc);
        const float2 ca = load2(s_cw + i0 * RS + kc), cb = load2(s_cw + i1 * RS + kc);
        const float2 uu = load2(s_u + kc);
        float2 kj[4], cj[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + (e & 1) + 8 * (e >> 1);
          kj[e] = load2(s_k + j * RS + kc);
          cj[e] = load2(s_cw + (j + 1) * RS + kc);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float r0 = half ? ra.y : ra.x, r1 = half ? rb.y : rb.x;
          const float cs0 = half ? ca.y : ca.x, cs1 = half ? cb.y : cb.x;
          const float uk = half ? uu.y : uu.x;
          float kv[4], cv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            kv[e] = half ? kj[e].y : kj[e].x;
            cv[e] = half ? cj[e].y : cj[e].x;
          }
          // (i0, j0), (i0, j0 + 1)
          float e00 = exp2_neg(cs0 - cv[0]), e01 = exp2_neg(cs0 - cv[1]);
          e00 = live0 ? e00 : (diag0 ? uk : 0.0f);
          e01 = live1 ? e01 : (diag1 ? uk : 0.0f);
          acc_dg[0][0] = fmaf(r0 * kv[0], e00, acc_dg[0][0]);
          acc_dg[0][1] = fmaf(r0 * kv[1], e01, acc_dg[0][1]);
          // (i1, j0), (i1, j0 + 1): always below the diagonal
          acc_dg[0][2] = fmaf(r1 * kv[0], exp2_neg(cs1 - cv[0]), acc_dg[0][2]);
          acc_dg[0][3] = fmaf(r1 * kv[1], exp2_neg(cs1 - cv[1]), acc_dg[0][3]);
          // (i1, j0 + 8), (i1, j0 + 9): as (i0, j0), (i0, j0 + 1)
          float e12 = exp2_neg(cs1 - cv[2]), e13 = exp2_neg(cs1 - cv[3]);
          e12 = live0 ? e12 : (diag0 ? uk : 0.0f);
          e13 = live1 ? e13 : (diag1 ? uk : 0.0f);
          acc_dg[1][2] = fmaf(r1 * kv[2], e12, acc_dg[1][2]);
          acc_dg[1][3] = fmaf(r1 * kv[3], e13, acc_dg[1][3]);
        }
      }
    }

    // off-diagonal blocks (a, b), b < a: (r e^(cs - n_b)) (k e^(n_b - cw))^T
#pragma unroll
    for (int b = 0; b < kWarps - 1; ++b) {
      if (b >= a) continue;
      const float* nb = s_cw + (kSub * b + kSub) * RS;  // cw at b's last row
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const int kc = 16 * ks + 2 * t;
        FragA fa;
        {
          float2 p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e & 1 ? i1 : i0, col = kc + 8 * (e >> 1);
            const float2 rr = load2(s_r + row * RS + col), cs = load2(s_cw + row * RS + col);
            const float2 n = load2(nb + col);
            p[e] = make_float2(rr.x * exp2_neg(cs.x - n.x), rr.y * exp2_neg(cs.y - n.y));
          }
          fa.set(p);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int j = kSub * b + 8 * nt + g;
          FragB fb;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = kc + 8 * e;
            const float2 kk = load2(s_k + j * RS + col), cw = load2(s_cw + (j + 1) * RS + col);
            const float2 n = load2(nb + col);
            split(kk.x * exp2_neg(n.x - cw.x), kk.y * exp2_neg(n.y - cw.y), fb.hi[e], fb.lo[e]);
          }
          mma_split<false>(acc_sc[b][nt], fa, fb);
        }
      }
    }

    // v rows j0..j0 + 15 as the B operand of the n8 tiles at columns n0 and
    // n0 + 8: bf16 v straight from shared memory by ldmatrix (transposed),
    // fp32 v gathered and split
    auto v_frags = [&](int j0, int n0, FragB (&fb)[2]) {
      if constexpr (kVExact) {
        const T* row = s_v + (j0 + (lane & 15)) * VS + n0 + 8 * (lane >> 4);
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(fb[0].hi[0]), "=r"(fb[0].hi[1]), "=r"(fb[1].hi[0]), "=r"(fb[1].hi[1])
                     : "r"(smem_addr(row))
                     : "memory");
      } else {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + 2 * t + 8 * e, n = n0 + 8 * h2 + g;
            split(to_float(s_v[j * VS + n]), to_float(s_v[(j + 1) * VS + n]), fb[h2].hi[e],
                  fb[h2].lo[e]);
          }
      }
    };

    // y = score v + (r e^cs) S, in kYParts passes over the V tile's columns
#pragma unroll
    for (int yp = 0; yp < kYParts; ++yp) {
      constexpr int kYTiles = kVTile / 8 / kYParts;
      float acc_y[kYTiles][4];
#pragma unroll
      for (int nt = 0; nt < kYTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_y[nt][e] = 0.0f;
#pragma unroll
      for (int b = 0; b < kWarps; ++b) {
        if (b > a) continue;
        // the accumulator's C layout is the A layout of the next product
        float sc[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] = b == a ? acc_dg[nt][e] : acc_sc[b < kWarps - 1 ? b : 0][nt][e];
        FragA fa;
        const float2 p[4] = {make_float2(sc[0][0], sc[0][1]), make_float2(sc[0][2], sc[0][3]),
                             make_float2(sc[1][0], sc[1][1]), make_float2(sc[1][2], sc[1][3])};
        fa.set(p);
#pragma unroll
        for (int nt = 0; nt < kYTiles; nt += 2) {
          FragB fb[2];
          v_frags(kSub * b, 8 * (yp * kYTiles + nt), fb);
          mma_split<kVExact>(acc_y[nt], fa, fb[0]);
          mma_split<kVExact>(acc_y[nt + 1], fa, fb[1]);
        }
      }
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const int kc = 16 * ks + 2 * t;
        FragA fa;
        {
          float2 p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e & 1 ? i1 : i0, col = kc + 8 * (e >> 1);
            const float2 rr = load2(s_r + row * RS + col), cs = load2(s_cw + row * RS + col);
            p[e] = make_float2(rr.x * exp2_neg(cs.x), rr.y * exp2_neg(cs.y));
          }
          fa.set(p);
        }
#pragma unroll
        for (int nt = 0; nt < kYTiles; ++nt) {
          const int n = 8 * (yp * kYTiles + nt) + g;
          FragB fb;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            fb.hi[e] = *reinterpret_cast<const uint32_t*>(s_sth + n * RS + kc + 8 * e);
            fb.lo[e] = *reinterpret_cast<const uint32_t*>(s_stl + n * RS + kc + 8 * e);
          }
          mma_split<false>(acc_y[nt], fa, fb);
        }
      }
      T* yrow0 = y + ((static_cast<size_t>(bi) * l + c0 + i0) * row_stride + hi) * vd + v0;
      T* yrow1 = yrow0 + 8 * row_stride * vd;
#pragma unroll
      for (int nt = 0; nt < kYTiles; ++nt) {
        const int col = 8 * (yp * kYTiles + nt) + 2 * t;
        if (col >= nv) continue;  // nv is a multiple of 16
        if (i0 < q) store2(yrow0 + col, acc_y[nt][0], acc_y[nt][1]);
        if (i1 < q) store2(yrow1 + col, acc_y[nt][2], acc_y[nt][3]);
      }
    }

    // S = exp2(total) S + (k e^(total - cw))^T v on this warp's tiles
    {
      const float* total = s_cw + kChunk * RS;
#pragma unroll
      for (int m = 0; m < kStateM; ++m) {
        const int kr = 16 * (st_m0 + m) + g;  // channels kr, kr + 8
        const float et0 = exp2_neg(total[kr]), et1 = exp2_neg(total[kr + 8]);
#pragma unroll
        for (int n = 0; n < kStateN; ++n) {
          acc_s[m][n][0] *= et0;
          acc_s[m][n][1] *= et0;
          acc_s[m][n][2] *= et1;
          acc_s[m][n][3] *= et1;
        }
#pragma unroll
        for (int js = 0; js < kChunk / 16; ++js) {
          FragA fa;
          float2 p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ch = kr + 8 * (e & 1), j = 16 * js + 2 * t + 8 * (e >> 1);
            const float tot = total[ch];
            p[e] = make_float2(
                to_float(s_k[j * RS + ch]) * exp2_neg(tot - s_cw[(j + 1) * RS + ch]),
                to_float(s_k[(j + 1) * RS + ch]) * exp2_neg(tot - s_cw[(j + 2) * RS + ch]));
          }
          fa.set(p);
#pragma unroll
          for (int n = 0; n < kStateN; n += 2) {
            FragB fb[2];
            v_frags(16 * js, 8 * (st_n0 + n), fb);
            mma_split<kVExact>(acc_s[m][n], fa, fb[0]);
            mma_split<kVExact>(acc_s[m][n + 1], fa, fb[1]);
          }
        }
      }
    }
    __syncthreads();  // every read of the previous state copy is done
    // the new state as bf16 hi and lo, [V column][K channel], for the next chunk
#pragma unroll
    for (int m = 0; m < kStateM; ++m) {
      const int kr = 16 * (st_m0 + m) + g;
#pragma unroll
      for (int n = 0; n < kStateN; ++n) {
        const int col = 8 * (st_n0 + n) + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = (col + (e & 1)) * RS + kr + 8 * (e >> 1);
          const float x = acc_s[m][n][e];
          const __nv_bfloat16 xh = __float2bfloat16_rn(x);
          s_sth[idx] = xh;
          s_stl[idx] = __float2bfloat16_rn(x - __bfloat162float(xh));
        }
      }
    }
  }

  float* out = state + static_cast<size_t>(bh) * kd * vd + v0;
#pragma unroll
  for (int m = 0; m < kStateM; ++m) {
    const int kr = 16 * (st_m0 + m) + g;
#pragma unroll
    for (int n = 0; n < kStateN; ++n) {
      const int col = 8 * (st_n0 + n) + 2 * t;
      if (col >= nv) continue;
      if (kr < kd) store2(out + static_cast<size_t>(kr) * vd + col, acc_s[m][n][0], acc_s[m][n][1]);
      if (kr + 8 < kd) {
        store2(out + static_cast<size_t>(kr + 8) * vd + col, acc_s[m][n][2], acc_s[m][n][3]);
      }
    }
  }
}

template <typename T, typename TW, int KP>
cudaError_t prepare(int* smem) {
  *smem = Layout<T, TW, KP>::kBytes;
  return cudaFuncSetAttribute(wkv_kernel<T, TW, KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
}

template <typename T, typename TW, int KP>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const float* u,
                   void* y, float* state, int bsz, int l, int h, int kd, int vd,
                   cudaStream_t stream) {
  int smem = 0;
  cudaError_t err = prepare<T, TW, KP>(&smem);
  if (err != cudaSuccess) return err;
  const int n_vt = (vd + kVTile - 1) / kVTile;
  wkv_kernel<T, TW, KP><<<bsz * h * n_vt, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TW*>(w), u, static_cast<T*>(y), state, l, h, kd, vd);
  return cudaGetLastError();
}

template <typename T, typename TW, int KP>
cudaError_t occupancy(int* blocks) {
  int smem = 0;
  cudaError_t err = prepare<T, TW, KP>(&smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, wkv_kernel<T, TW, KP>, kThreads, smem);
}

template <typename T, typename TW>
cudaError_t launch_k(const void* r, const void* k, const void* v, const void* w, const float* u,
                     void* y, float* state, int bsz, int l, int h, int kd, int vd,
                     cudaStream_t stream) {
  if (kd <= 16) return launch<T, TW, 16>(r, k, v, w, u, y, state, bsz, l, h, kd, vd, stream);
  if (kd <= 32) return launch<T, TW, 32>(r, k, v, w, u, y, state, bsz, l, h, kd, vd, stream);
  if (kd <= 64) return launch<T, TW, 64>(r, k, v, w, u, y, state, bsz, l, h, kd, vd, stream);
  return launch<T, TW, kMaxDim>(r, k, v, w, u, y, state, bsz, l, h, kd, vd, stream);
}

template <typename T, typename TW>
cudaError_t occupancy_k(int kd, int* blocks) {
  if (kd <= 16) return occupancy<T, TW, 16>(blocks);
  if (kd <= 32) return occupancy<T, TW, 32>(blocks);
  if (kd <= 64) return occupancy<T, TW, 64>(blocks);
  return occupancy<T, TW, kMaxDim>(blocks);
}

bool bad_args(int kd, int vd, int bf16, int w_bf16) {
  return kd % 16 || vd % 16 || kd < 16 || vd < 16 || kd > kMaxDim || vd > kMaxDim ||
         (w_bf16 && !bf16);
}

}  // namespace

// bf16 != 0: r, k, v and y are bf16, else fp32; w_bf16 != 0: w is bf16 (only
// with bf16 r), else fp32; u and the state are fp32.  K and V are multiples
// of 16 up to 128; every pointer is 16-byte aligned.  Returns
// cudaGetLastError().
extern "C" int wkv_launch(const void* r, const void* k, const void* v, const void* w,
                          const void* u, void* y, void* state, int bsz, int l, int h, int kd,
                          int vd, int bf16, int w_bf16, void* stream) {
  if (bad_args(kd, vd, bf16, w_bf16)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  float* st = static_cast<float*>(state);
  if (bf16 && w_bf16) {
    return launch_k<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, uf, y, st, bsz, l, h, kd, vd, s);
  }
  if (bf16) return launch_k<__nv_bfloat16, float>(r, k, v, w, uf, y, st, bsz, l, h, kd, vd, s);
  return launch_k<float, float>(r, k, v, w, uf, y, st, bsz, l, h, kd, vd, s);
}

// Blocks of the instance for (K, dtypes) resident on one SM, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, into *blocks.
extern "C" int wkv_occupancy(int kd, int bf16, int w_bf16, int* blocks) {
  if (bad_args(kd, 16, bf16, w_bf16)) return cudaErrorInvalidValue;
  if (bf16 && w_bf16) return occupancy_k<__nv_bfloat16, __nv_bfloat16>(kd, blocks);
  if (bf16) return occupancy_k<__nv_bfloat16, float>(kd, blocks);
  return occupancy_k<float, float>(kd, blocks);
}
