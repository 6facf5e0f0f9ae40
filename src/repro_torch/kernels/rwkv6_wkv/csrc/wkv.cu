// RWKV6 ("Finch") WKV core for Hopper (sm_90a), chunked form with
// per-channel data-dependent decay.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_wkv/kernel.py::_wkv_kernel
// (launched by wkv_fwd).  Its plain PyTorch version is
// src/repro_torch/kernels/rwkv6_wkv/ref.py::wkv_chunked; the kernel computes
// the same chunked sums in fp32.  Per (batch, head), over chunks of 64 rows,
// with lw = log(clip(w, 1e-20, 1)), cw its inclusive cumsum inside the chunk,
// cs = cw - lw the exclusive one and total = cw[last]:
//   intra-chunk  y_i += sum_{j<i} (sum_k r_ik k_jk exp(cs_ik - cw_jk)) v_j
//   bonus        y_i += (sum_k r_ik u_k k_ik) v_i
//   inter-chunk  y_i += (r_i * exp(cs_i)) S
//   state        S    = exp(total) * S + sum_j (k_j * exp(total - cw_j))^T v_j
// and the final S is written in fp32.
//
// The TPU kernel built the (Q, Q, K) pair-decay tensor in VMEM (1 MB at
// Q = K = 64); a block here has at most 227 KB of shared memory, so the
// pair decays are never stored: each score entry is a K-loop with one exp
// per term.  Every exponent is a difference of cumulative log decays with
// j <= i - 1, so it is <= 0 (clamped at 0 against rounding, and for the
// masked pairs j >= i, whose results are discarded): no exp(+cum) factor,
// which overflows under strong decay (w = 1e-12 gives chunk cumsums near
// -1768).  The log decays are kept in base 2, so each term's exp is one
// exp2f.
//
// What bounds it on the card: bytes, counting each input read once and each
// output written once (r, k, v, y in bf16, w fp32, the fp32 state: about
// 5.06e8 bytes at the rwkv6-3b serving shape B = 4, L = 4096, H = 40, K = V = 64, against
// about 2e10 operations at the bf16 tensor-core peak).  This design runs on
// the CUDA cores and the special-function units (Q^2 K / 2 exp2f per chunk
// for the score), far from that bound; it reads each input byte once and
// writes each output byte once:
//   * r, k, v and w are read in their own dtype and the model's (B, L, H, .)
//     layout; log2(clip(w)) is taken as w is staged, so the TPU wrapper's
//     fp32 copies, (BH, L, .) transposes and replicated u rows are never
//     built; u is read as (H, K);
//   * one block of 512 threads per (batch, head, 64-column tile of V) walks
//     its chunks in order (the TPU's sequential grid axis becomes this loop),
//     with its (K, V tile) state in shared memory for the whole sequence;
//     nothing carries between blocks.  A V tile recomputes the chunk's
//     score, so V <= 64 (the serving shape) is one tile;
//   * each thread loads its share of the next chunk into registers before
//     the current chunk's arithmetic, so global latency hides behind it;
//   * r, k and the two cumsums are staged transposed, [K][Q], so a score
//     tile of 4 x 4 pairs reads four float4s per channel; the 136 tiles on
//     or below the diagonal are split into two halves of K each (272
//     threads, summed by a shuffle) while 64 other threads compute the bonus
//     coefficients;
//   * a ragged last chunk is masked: rows past L load r = k = v = 0 and
//     w = 1 (log w = 0), the JAX wrapper's identity padding, so the final
//     state is the unpadded one, and their y is not written.
// K and V are multiples of 16 up to 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;  // ops.CHUNK on the Python side
constexpr int kThreads = 512;  // 32 x 16
constexpr int kRowLanes = kThreads / kChunk;  // threads that stage one row of a chunk
constexpr int kQS = kChunk + 4;  // row stride of the [K][Q] tiles: rows stay 16-byte aligned
constexpr int kSS = kChunk + 1;  // row stride of the [Q][Q] score tile
constexpr int kVTile = 64;  // V columns per block
constexpr int kVS = kVTile + 8;  // row stride of the [Q][V tile] tile: staging stores hit distinct banks
constexpr int kMaxKCols = 8;  // up to 128 / 16 rows of K
constexpr int kScoreTiles = (kChunk / 4) * (kChunk / 4 + 1) / 2;  // 4 x 4 tiles with j <= i
constexpr int kScoreUnits = 2 * kScoreTiles;  // each tile's K-loop in two halves
constexpr int kScoreWarps = (kScoreUnits + 31) / 32;
constexpr int kCoeffThread0 = kThreads - kChunk;  // threads that compute the bonus coefficients

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(x.x, x.y);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(x.z, x.w);
}
__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

int smem_floats(int kd) {
  return 4 * kd * kQS + kChunk * kVS + kd * kVTile + kChunk * kSS + kChunk + 2 * kd;
}

// This thread's share of one chunk's inputs, held in registers from the
// loads of chunk c + 1 (issued before chunk c's arithmetic) to their stores
// into shared memory at the top of chunk c + 1.  Thread (row, part) holds the
// channels part, part + 8, ... of one row: across a warp the loads of one
// element index read 8 neighbouring channels of 4 rows, and the transposed
// stores hit 32 distinct banks.
template <typename T, typename TW, int KC>
struct Staged {
  T r[2 * KC], k[2 * KC];
  TW w[2 * KC];
  T v[kVTile / kRowLanes];

  __device__ __forceinline__ void load(const T* __restrict__ rg, const T* __restrict__ kg,
                                       const T* __restrict__ vg, const TW* __restrict__ wg,
                                       int bi, int hi, int c0, int l, int h, int kd, int vd,
                                       int v0, int nv, int row, int part) {
    const bool live = c0 + row < l;  // rows past L are the identity: r = k = v = 0, w = 1
    const size_t base = (static_cast<size_t>(bi) * l + c0 + row) * h + hi;
#pragma unroll
    for (int e = 0; e < 2 * KC; ++e) {
      const int kc = e * kRowLanes + part;
      if (kc < kd) {
        r[e] = live ? rg[base * kd + kc] : T(0.0f);
        k[e] = live ? kg[base * kd + kc] : T(0.0f);
        w[e] = live ? wg[base * kd + kc] : TW(1.0f);
      }
    }
#pragma unroll
    for (int e = 0; e < kVTile / kRowLanes; ++e) {
      const int c = e * kRowLanes + part;
      if (c < nv) v[e] = live ? vg[base * vd + v0 + c] : T(0.0f);
    }
  }

  // r, k and log2(clip(w, 1e-20, 1)) into the [K][Q] tiles, v into [Q][V tile]
  __device__ __forceinline__ void store_to(float* s_r, float* s_k, float* s_lw, float* s_v,
                                           int kd, int nv, int row, int part) const {
#pragma unroll
    for (int e = 0; e < 2 * KC; ++e) {
      const int kc = e * kRowLanes + part;
      if (kc < kd) {
        s_r[kc * kQS + row] = to_float(r[e]);
        s_k[kc * kQS + row] = to_float(k[e]);
        s_lw[kc * kQS + row] = log2f(fminf(fmaxf(to_float(w[e]), 1e-20f), 1.0f));
      }
    }
#pragma unroll
    for (int e = 0; e < kVTile / kRowLanes; ++e) {
      const int c = e * kRowLanes + part;
      if (c < nv) s_v[row * kVS + c] = to_float(v[e]);
    }
  }
};

// KC: K / 16 rounded up to a power of two; the register arrays are sized
// for it and a smaller K skips the spare entries.
template <typename T, typename TW, int KC>
__global__ void __launch_bounds__(kThreads, 1) wkv_kernel(
    const T* __restrict__ r,     // (B, L, H, K)
    const T* __restrict__ k,     // (B, L, H, K)
    const T* __restrict__ v,     // (B, L, H, V)
    const TW* __restrict__ w,    // (B, L, H, K) decay in (0, 1)
    const float* __restrict__ u,  // (H, K) bonus
    T* __restrict__ y,           // (B, L, H, V)
    float* __restrict__ state,   // (B, H, K, V)
    int l, int h, int kd, int vd) {
  constexpr int kStateRows = KC > 1 ? KC / 2 : 1;  // rows of K per thread in the state update
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_r = smem;                     // [K][Q] r, then r * exp(cs)
  float* s_k = s_r + kd * kQS;           // [K][Q] k, then k * exp(total - cw)
  float* s_cw = s_k + kd * kQS;          // [K][Q] inclusive cumsum of log2 w
  float* s_cs = s_cw + kd * kQS;         // [K][Q] log2 w, then its exclusive cumsum
  float* s_v = s_cs + kd * kQS;          // [Q][V tile], rows kVS apart
  float* s_st = s_v + kChunk * kVS;      // [K][V tile] carried state
  float* s_sc = s_st + kd * kVTile;      // [Q][Q + 1] scores, j < i
  float* s_coef = s_sc + kChunk * kSS;   // [Q] bonus coefficients
  float* s_u = s_coef + kChunk;          // [K]
  float* s_et = s_u + kd;                // [K] exp(total)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;  // 0..31
  const int lane = tid & 31;
  const int n_vt = (vd + kVTile - 1) / kVTile;
  const int bh = blockIdx.x / n_vt;
  const int v0 = (blockIdx.x % n_vt) * kVTile;
  const int bi = bh / h;
  const int hi = bh % h;
  const int nv = min(kVTile, vd - v0);  // a multiple of 16
  const int row = tid / kRowLanes;
  const int part = tid % kRowLanes;

  // this thread's score unit: 4 x 4 tile (ti, tj), tj <= ti, numbered row by
  // row, and the half of the K-loop it sums
  const int tile = tid >> 1;
  const int half = tid & 1;
  int ti = static_cast<int>((sqrtf(8.0f * tile + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
  while (ti * (ti + 1) / 2 > tile) --ti;
  const int tj = tile - ti * (ti + 1) / 2;

  for (int idx = tid; idx < kd * kVTile; idx += kThreads) s_st[idx] = 0.0f;
  for (int idx = tid; idx < kd; idx += kThreads) s_u[idx] = u[hi * kd + idx];

  Staged<T, TW, KC> staged;
  staged.load(r, k, v, w, bi, hi, 0, l, h, kd, vd, v0, nv, row, part);

  for (int c0 = 0; c0 < l; c0 += kChunk) {
    const int q = min(kChunk, l - c0);  // real rows of this chunk
    __syncthreads();  // the previous chunk's reads and state update are done
    staged.store_to(s_r, s_k, s_cs, s_v, kd, nv, row, part);
    __syncthreads();
    // the next chunk's loads fly while this one is computed
    if (c0 + kChunk < l) staged.load(r, k, v, w, bi, hi, c0 + kChunk, l, h, kd, vd, v0, nv, row, part);

    // cumsums of log2 w along the chunk: one warp per row of K, two entries a lane
    for (int kc = tid >> 5; kc < kd; kc += kThreads / 32) {
      float* lw = s_cs + kc * kQS;
      const float a0 = lw[2 * lane], a1 = lw[2 * lane + 1];
      float inc = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) excl = 0.0f;
      s_cw[kc * kQS + 2 * lane] = excl + a0;
      s_cw[kc * kQS + 2 * lane + 1] = inc;
      lw[2 * lane] = excl;
      lw[2 * lane + 1] = excl + a0;
    }
    __syncthreads();

    if (tid < 32 * kScoreWarps) {
      // score_ij = sum_k r_ik k_jk exp2(cs_ik - cw_jk) on this unit's tile and half of K
      float acc[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.0f;
      if (tid < kScoreUnits) {
        const int k_end = (half + 1) * (kd / 2);
#pragma unroll 2
        for (int kc = half * (kd / 2); kc < k_end; ++kc) {
          const float4 rv = *reinterpret_cast<const float4*>(s_r + kc * kQS + 4 * ti);
          const float4 cs = *reinterpret_cast<const float4*>(s_cs + kc * kQS + 4 * ti);
          const float4 kv = *reinterpret_cast<const float4*>(s_k + kc * kQS + 4 * tj);
          const float4 cw = *reinterpret_cast<const float4*>(s_cw + kc * kQS + 4 * tj);
          const float ra[4] = {rv.x, rv.y, rv.z, rv.w};
          const float ca[4] = {cs.x, cs.y, cs.z, cs.w};
          const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
          const float wa[4] = {cw.x, cw.y, cw.z, cw.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const float e = exp2f(fminf(ca[ii] - wa[jj], 0.0f));
              acc[ii][jj] = fmaf(ra[ii] * ka[jj], e, acc[ii][jj]);
            }
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] += __shfl_xor_sync(0xffffffffu, acc[ii][jj], 1);
      if (tid < kScoreUnits && half == 0) {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int i = 4 * ti + ii, j = 4 * tj + jj;
            s_sc[i * kSS + j] = j < i ? acc[ii][jj] : 0.0f;
          }
      }
    } else if (tid >= kCoeffThread0) {
      const int i = tid - kCoeffThread0;
      float c = 0.0f;
      for (int kc = 0; kc < kd; ++kc) c = fmaf(s_r[kc * kQS + i] * s_u[kc], s_k[kc * kQS + i], c);
      s_coef[i] = c;
    }
    if (tid < kd) s_et[tid] = s_cw[tid * kQS + kChunk - 1];  // total, until the fold below
    __syncthreads();

    // fold the decays into r (inter-chunk) and k (state update)
    for (int idx = tid; idx < kd * kChunk; idx += kThreads) {
      const int kc = idx / kChunk, i = idx % kChunk;
      s_r[kc * kQS + i] *= exp2f(s_cs[kc * kQS + i]);
      s_k[kc * kQS + i] *= exp2f(fminf(s_et[kc] - s_cw[kc * kQS + i], 0.0f));
    }
    __syncthreads();
    if (tid < kd) s_et[tid] = exp2f(s_et[tid]);  // read only after the next barrier

    // y = score v + coef * v + (r exp(cs)) S; thread: rows 2ty, 2ty + 1, cols 4tx..4tx + 3
    const bool cols_live = 4 * tx < nv;  // nv is a multiple of 16: all four columns or none
    {
      float4 acc0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), acc1 = acc0;
      const int j_end = cols_live ? 2 * ty + 2 : 0;  // the scores are zero beyond this thread's last row
#pragma unroll 4
      for (int j = 0; j < j_end; ++j) {
        const float s0 = s_sc[(2 * ty) * kSS + j], s1 = s_sc[(2 * ty + 1) * kSS + j];
        fma4(acc0, s0, *reinterpret_cast<const float4*>(s_v + j * kVS + 4 * tx));
        fma4(acc1, s1, *reinterpret_cast<const float4*>(s_v + j * kVS + 4 * tx));
      }
      if (cols_live) {
        fma4(acc0, s_coef[2 * ty], *reinterpret_cast<const float4*>(s_v + (2 * ty) * kVS + 4 * tx));
        fma4(acc1, s_coef[2 * ty + 1],
             *reinterpret_cast<const float4*>(s_v + (2 * ty + 1) * kVS + 4 * tx));
      }
      const int k_end = cols_live ? kd : 0;
#pragma unroll 4
      for (int kc = 0; kc < k_end; ++kc) {
        const float2 rv = *reinterpret_cast<const float2*>(s_r + kc * kQS + 2 * ty);
        const float4 sv = *reinterpret_cast<const float4*>(s_st + kc * kVTile + 4 * tx);
        fma4(acc0, rv.x, sv);
        fma4(acc1, rv.y, sv);
      }
      if (cols_live) {
        const size_t y0 = ((static_cast<size_t>(bi) * l + c0 + 2 * ty) * h + hi) * vd + v0 + 4 * tx;
        if (2 * ty < q) store4(y + y0, acc0);
        if (2 * ty + 1 < q) store4(y + y0 + static_cast<size_t>(h) * vd, acc1);
      }
    }
    __syncthreads();  // every read of the old state is done

    // S = exp(total) S + sum_j (k_j exp(total - cw_j))^T v_j; thread: rows ty + 32kk, cols 4tx..4tx + 3
    if (cols_live) {
      float4 acc[kStateRows];
#pragma unroll
      for (int kk = 0; kk < kStateRows; ++kk) acc[kk] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int j = 0; j < kChunk; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(s_v + j * kVS + 4 * tx);
#pragma unroll
        for (int kk = 0; kk < kStateRows; ++kk) {
          const int kr = ty + 32 * kk;
          if (kr < kd) fma4(acc[kk], s_k[kr * kQS + j], vv);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kStateRows; ++kk) {
        const int kr = ty + 32 * kk;
        if (kr >= kd) continue;
        const float et = s_et[kr];
        float4* sp = reinterpret_cast<float4*>(s_st + kr * kVTile + 4 * tx);
        const float4 old = *sp;
        *sp = make_float4(fmaf(et, old.x, acc[kk].x), fmaf(et, old.y, acc[kk].y),
                          fmaf(et, old.z, acc[kk].z), fmaf(et, old.w, acc[kk].w));
      }
    }
  }
  __syncthreads();
  float* out = state + static_cast<size_t>(bh) * kd * vd + v0;
  for (int idx = tid; idx < kd * nv; idx += kThreads) {
    const int kc = idx / nv, c = idx % nv;
    out[static_cast<size_t>(kc) * vd + c] = s_st[kc * kVTile + c];
  }
}

template <typename T, typename TW, int KC>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const float* u,
                   void* y, float* state, int bsz, int l, int h, int kd, int vd,
                   cudaStream_t stream) {
  const int smem = smem_floats(kd) * static_cast<int>(sizeof(float));
  auto kernel = wkv_kernel<T, TW, KC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_vt = (vd + kVTile - 1) / kVTile;
  kernel<<<bsz * h * n_vt, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TW*>(w), u, static_cast<T*>(y), state, l, h, kd, vd);
  return cudaGetLastError();
}

template <typename T, typename TW>
cudaError_t launch_k(const void* r, const void* k, const void* v, const void* w, const float* u,
                     void* y, float* state, int bsz, int l, int h, int kd, int vd,
                     cudaStream_t stream) {
  const int rows = kd / 16;
  if (rows <= 1) return launch<T, TW, 1>(r, k, v, w, u, y, state, bsz, l, h, kd, vd, stream);
  if (rows <= 2) return launch<T, TW, 2>(r, k, v, w, u, y, state, bsz, l, h, kd, vd, stream);
  if (rows <= 4) return launch<T, TW, 4>(r, k, v, w, u, y, state, bsz, l, h, kd, vd, stream);
  return launch<T, TW, kMaxKCols>(r, k, v, w, u, y, state, bsz, l, h, kd, vd, stream);
}

}  // namespace

// bf16 != 0: r, k, v and y are bf16, else fp32; w_bf16 != 0: w is bf16 (only
// with bf16 r), else fp32; u and the state are fp32.  K and V are multiples
// of 16 up to 128.  Returns cudaGetLastError().
extern "C" int wkv_launch(const void* r, const void* k, const void* v, const void* w,
                          const void* u, void* y, void* state, int bsz, int l, int h, int kd,
                          int vd, int bf16, int w_bf16, void* stream) {
  const int max_dim = 16 * kMaxKCols;
  if (kd % 16 || vd % 16 || kd < 16 || vd < 16 || kd > max_dim || vd > max_dim ||
      (w_bf16 && !bf16)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  float* st = static_cast<float*>(state);
  if (bf16 && w_bf16) {
    return launch_k<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, uf, y, st, bsz, l, h, kd, vd, s);
  }
  if (bf16) return launch_k<__nv_bfloat16, float>(r, k, v, w, uf, y, st, bsz, l, h, kd, vd, s);
  return launch_k<float, float>(r, k, v, w, uf, y, st, bsz, l, h, kd, vd, s);
}
