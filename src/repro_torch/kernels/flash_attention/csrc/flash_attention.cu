// Flash attention forward for Hopper (sm_90a): online-softmax attention over
// (B, H, L, D) q/k/v with causal and sliding-window masks, logit soft-cap,
// GQA and a query offset.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::_fa_kernel (launched by
// flash_attention_fwd).  Its plain PyTorch version is
// src/repro_torch/kernels/flash_attention/ref.py::mha_blocked; both keep the
// running max, denominator and accumulator in fp32 and agree to fp32
// rounding (no fast-math: expf, tanhf and the final division stay IEEE).
//
// What bounds it on the card: operations.  At the zamba2-1.2b serving shape
// (B = 4, L = 4096, 32 heads, D = 64, causal) it does about 2.75e11 flop on
// 2.7e8 bytes, about 1000 flop per byte, far above the card's balance point
// (~295 flop/byte against the bf16 tensor cores).  This first design runs
// those flops as fp32 FMAs on the CUDA cores, so it is far from that bound
// (67 TFLOP/s fp32 against 989 TFLOP/s bf16): moving the two products onto
// the tensor cores (mma.sync / wgmma) with TMA-fed tiles is later work.
// What it does do:
//   * one block per (64-row q tile, q head, batch); K/V tiles of BK rows
//     (64, or 32 at D = 256) are staged in shared memory in fp32, and the
//     q tile stays in shared memory for the whole kv loop, so q is read once
//     and each K/V tile once per q tile;
//   * kv tiles with no live (row, col) pair are skipped with the geometry of
//     _fa_kernel (causal: col_min <= last row; window: col_max > first row -
//     window), so a causal prefill does about half the tiles;
//   * the scores, probabilities and output are register-tiled: 256 threads as
//     16 x 16, thread (ty, tx) owns q rows 4ty..4ty+3, score columns
//     tx + 16j and output columns tx + 16j; the row max and sum are
//     __shfl_xor reductions over the 16 lanes of a row;
//   * masked scores give p = 0 explicitly, so a row with no live column in a
//     tile adds nothing (the TPU kernel let a later tile's alpha = 0 wipe it).
// Inputs are fp32 or bf16 and are converted to fp32 as they are staged; the
// output is written in the input dtype.  D is a template parameter
// (16, 32, 64, 128, 256).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRowsPerThread = kBlockQ / 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q,  // (B, Hq, Lq, D)
    const T* __restrict__ k,  // (B, Hkv, Lk, D)
    const T* __restrict__ v,  // (B, Hkv, Lk, D)
    T* __restrict__ o,        // (B, Hq, Lq, D)
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
  const T* qg = q + (static_cast<size_t>(b) * hq + h) * lq * D;
  const T* kg = k + (static_cast<size_t>(b) * hkv + hk) * lk * D;
  const T* vg = v + (static_cast<size_t>(b) * hkv + hk) * lk * D;
  T* og = o + (static_cast<size_t>(b) * hq + h) * lq * D;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    qs[r * QS + d] = q0 + r < lq ? to_float(qg[static_cast<size_t>(q0 + r) * D + d]) : 0.0f;
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
      ks[r * QS + d] = in ? to_float(kg[g]) : 0.0f;
      vs[r * D + d] = in ? to_float(vg[g]) : 0.0f;
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
      store(&og[static_cast<size_t>(r) * D + tx + 16 * dj], acc[i][dj] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv,
                   int lq, int lk, int causal, int window, float softcap, float scale,
                   int q_offset, cudaStream_t stream) {
  const int smem = Tile<D>::kSmemFloats * static_cast<int>(sizeof(float));
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, hq, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), hq, hkv, lq, lk, causal, window, softcap, scale, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, void* o, int b, int hq,
                         int hkv, int lq, int lk, int d, int causal, int window, float softcap,
                         float scale, int q_offset, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, b, hq, hkv, lq, lk, causal, window, softcap, scale,
                           q_offset, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, b, hq, hkv, lq, lk, causal, window, softcap, scale,
                           q_offset, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, hq, hkv, lq, lk, causal, window, softcap, scale,
                           q_offset, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, hq, hkv, lq, lk, causal, window, softcap, scale,
                            q_offset, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, b, hq, hkv, lq, lk, causal, window, softcap, scale,
                            q_offset, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// window <= 0: no sliding window; softcap <= 0: no soft-cap.  bf16 != 0: q, k,
// v and o are bf16, else fp32.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int b, int hq, int hkv, int lq, int lk, int d, int bf16,
                                      int causal, int window, float softcap, float scale,
                                      int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_dtype<__nv_bfloat16>(q, k, v, o, b, hq, hkv, lq, lk, d, causal, window,
                                       softcap, scale, q_offset, s);
  }
  return launch_dtype<float>(q, k, v, o, b, hq, hkv, lq, lk, d, causal, window, softcap, scale,
                             q_offset, s);
}
