// Mamba2 SSD (state-space dual) core for Hopper (sm_90a), chunk-dual form.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba2_ssd/kernel.py::_ssd_kernel
// (launched by ssd_fwd).  Its plain PyTorch version is
// src/repro_torch/kernels/mamba2_ssd/ref.py::ssd_chunked; the kernel computes
// the same chunk-dual sums in fp32:
//   intra-chunk  y_i += sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   inter-chunk  y_i += exp(cum_i) C_i S
//   state        S    = exp(total) S + sum_j exp(total - cum_j) B_j (outer) dt_j x_j
// with cum the inclusive cumsum of dt * a inside the chunk and total its
// last value.  The chunk-dual form is exact for any chunk length; this
// kernel's chunk is 64 rows (the TPU kernel's was 128), which keeps the
// chunk's tiles and the carried state in shared memory at N = P = 128.
//
// What bounds it on the card: bytes.  At the zamba2-1.2b serving shape
// (B = 4, L = 4096, H = 64, P = N = 64) it reads x (bf16), dt (fp32), B and C
// (bf16, shared by all heads) and writes y (bf16) and the fp32 final state:
// about 2.8e8 bytes against 5.2e10 flop.  The design moves each of those
// bytes once:
//   * x * dt and dt * a are folded in the kernel as x and dt are staged,
//     and B/C are read as (B, L, N) by every head's block; the TPU wrapper's
//     xdt, lane-replicated loga and per-head B/C slabs are never built;
//   * one block per (batch, head) walks its chunks in order (the TPU's
//     sequential grid axis becomes this loop), with the (N, P) state in
//     shared memory for the whole sequence; nothing carries between blocks;
//   * all per-chunk intermediates (cumsum, C.B^T with its decay, the decay
//     weights) live in shared memory, and the three products are
//     register-tiled over 256 threads as 16 x 16 on fp32 CUDA-core FMAs
//     (the tensor cores are later work), with the tiles sized at compile
//     time for max(N, P) so no FMA is spent on absent columns;
//   * a ragged last chunk is masked: rows past L load x = B = C = 0 and
//     dt = 0, the same as the JAX wrapper's identity padding, so the final
//     state is the unpadded one, and their y is not written.
// exp is taken only for j <= i (the masked differences are positive and
// would overflow); exp(cum) and exp(total - cum) are <= 1 since a < 0.
// N and P are multiples of 16 up to 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;  // ops.CHUNK on the Python side
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRowsPerThread = kChunk / 16;
constexpr int kMaxCols = 8;  // up to 128 / 16 columns of P (or rows of N) per thread
constexpr int kMStride = kChunk + 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

int smem_floats(int n, int p) {
  return n * p + kChunk * p + 2 * kChunk * (n + 1) + kChunk * kMStride + 3 * kChunk;
}

// MC: columns of P (and rows of N) per thread the register tiles are sized
// for, max(P, N) / 16 rounded up to a power of two; smaller P or N skip the
// spare columns.
template <typename T, int MC>
__global__ void __launch_bounds__(kThreads) ssd_kernel(
    const T* __restrict__ x,       // (B, L, H, P)
    const float* __restrict__ dt,  // (B, L, H)
    const float* __restrict__ a,   // (H,)
    const T* __restrict__ bm,      // (B, L, N)
    const T* __restrict__ cm,      // (B, L, N)
    T* __restrict__ y,             // (B, L, H, P)
    float* __restrict__ state,     // (B, H, N, P)
    int l, int h, int p, int n) {
  extern __shared__ float smem[];
  const int ns = n + 1;  // padded rows: column reads of B hit distinct banks
  float* s_st = smem;                   // [N][P] carried state
  float* s_x = s_st + n * p;            // [Q][P] x * dt
  float* s_b = s_x + kChunk * p;        // [Q][N + 1]
  float* s_c = s_b + kChunk * ns;       // [Q][N + 1]
  float* s_m = s_c + kChunk * ns;       // [Q][Q + 1] (C B^T) * decay, zero above the diagonal
  float* s_cum = s_m + kChunk * kMStride;  // [Q] inclusive cumsum of dt * a
  float* s_ecum = s_cum + kChunk;       // [Q] exp(cum)
  float* s_w = s_ecum + kChunk;         // [Q] exp(total - cum)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bi = blockIdx.x / h;
  const int hi = blockIdx.x % h;
  const int pj = p / 16;
  const int nj = n / 16;
  const float ah = a[hi];

  for (int idx = tid; idx < n * p; idx += kThreads) s_st[idx] = 0.0f;

  for (int c0 = 0; c0 < l; c0 += kChunk) {
    const int q = min(kChunk, l - c0);  // real rows of this chunk
    __syncthreads();  // the previous chunk's reads and state update are done

    // stage x * dt, B, C; rows past L are zero (identity padding)
    for (int idx = tid; idx < kChunk * p; idx += kThreads) {
      const int i = idx / p, pc = idx % p;
      float v = 0.0f;
      if (i < q) {
        const size_t row = (static_cast<size_t>(bi) * l + c0 + i) * h + hi;
        v = to_float(x[row * p + pc]) * dt[row];
      }
      s_x[idx] = v;
    }
    for (int idx = tid; idx < kChunk * n; idx += kThreads) {
      const int i = idx / n, nc = idx % n;
      const size_t g = (static_cast<size_t>(bi) * l + c0 + i) * n + nc;
      s_b[i * ns + nc] = i < q ? to_float(bm[g]) : 0.0f;
      s_c[i * ns + nc] = i < q ? to_float(cm[g]) : 0.0f;
    }
    // inclusive cumsum of dt * a over the chunk: one warp, two rows a lane
    if (tid < 32) {
      const int i0 = 2 * tid, i1 = 2 * tid + 1;
      const size_t row0 = (static_cast<size_t>(bi) * l + c0 + i0) * h + hi;
      const float a0 = i0 < q ? dt[row0] * ah : 0.0f;
      const float a1 = i1 < q ? dt[row0 + h] * ah : 0.0f;
      float inc = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, inc, off);
        if (tid >= off) inc += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, inc, 1);
      if (tid == 0) excl = 0.0f;
      s_cum[i0] = excl + a0;
      s_cum[i1] = inc;
    }
    __syncthreads();

    const float total = s_cum[kChunk - 1];
    if (tid < kChunk) {
      s_ecum[tid] = expf(s_cum[tid]);
      s_w[tid] = expf(total - s_cum[tid]);
    }
    // M = (C B^T) * exp(cum_i - cum_j), j <= i; thread: rows 4ty.., cols tx + 16jj
    {
      float cb[kRowsPerThread][kRowsPerThread];
#pragma unroll
      for (int ii = 0; ii < kRowsPerThread; ++ii)
#pragma unroll
        for (int jj = 0; jj < kRowsPerThread; ++jj) cb[ii][jj] = 0.0f;
      for (int nc = 0; nc < n; ++nc) {
        float cv[kRowsPerThread], bv[kRowsPerThread];
#pragma unroll
        for (int ii = 0; ii < kRowsPerThread; ++ii) cv[ii] = s_c[(ty * kRowsPerThread + ii) * ns + nc];
#pragma unroll
        for (int jj = 0; jj < kRowsPerThread; ++jj) bv[jj] = s_b[(tx + 16 * jj) * ns + nc];
#pragma unroll
        for (int ii = 0; ii < kRowsPerThread; ++ii)
#pragma unroll
          for (int jj = 0; jj < kRowsPerThread; ++jj) cb[ii][jj] = fmaf(cv[ii], bv[jj], cb[ii][jj]);
      }
#pragma unroll
      for (int ii = 0; ii < kRowsPerThread; ++ii) {
        const int i = ty * kRowsPerThread + ii;
#pragma unroll
        for (int jj = 0; jj < kRowsPerThread; ++jj) {
          const int j = tx + 16 * jj;
          s_m[i * kMStride + j] = j <= i ? cb[ii][jj] * expf(s_cum[i] - s_cum[j]) : 0.0f;
        }
      }
    }
    __syncthreads();

    // y = M (x dt) + exp(cum) * (C S); thread: rows 4ty.., cols tx + 16jj
    {
      float yi[kRowsPerThread][MC], yo[kRowsPerThread][MC];
#pragma unroll
      for (int ii = 0; ii < kRowsPerThread; ++ii)
#pragma unroll
        for (int jj = 0; jj < MC; ++jj) yi[ii][jj] = yo[ii][jj] = 0.0f;
      const int j_end = (ty + 1) * kRowsPerThread;  // M is zero beyond this thread's last row
      for (int j = 0; j < j_end; ++j) {
        float mv[kRowsPerThread], xv[MC];
#pragma unroll
        for (int ii = 0; ii < kRowsPerThread; ++ii) mv[ii] = s_m[(ty * kRowsPerThread + ii) * kMStride + j];
#pragma unroll
        for (int jj = 0; jj < MC; ++jj) xv[jj] = jj < pj ? s_x[j * p + tx + 16 * jj] : 0.0f;
#pragma unroll
        for (int ii = 0; ii < kRowsPerThread; ++ii)
#pragma unroll
          for (int jj = 0; jj < MC; ++jj) yi[ii][jj] = fmaf(mv[ii], xv[jj], yi[ii][jj]);
      }
      for (int nc = 0; nc < n; ++nc) {
        float cv[kRowsPerThread], sv[MC];
#pragma unroll
        for (int ii = 0; ii < kRowsPerThread; ++ii) cv[ii] = s_c[(ty * kRowsPerThread + ii) * ns + nc];
#pragma unroll
        for (int jj = 0; jj < MC; ++jj) sv[jj] = jj < pj ? s_st[nc * p + tx + 16 * jj] : 0.0f;
#pragma unroll
        for (int ii = 0; ii < kRowsPerThread; ++ii)
#pragma unroll
          for (int jj = 0; jj < MC; ++jj) yo[ii][jj] = fmaf(cv[ii], sv[jj], yo[ii][jj]);
      }
#pragma unroll
      for (int ii = 0; ii < kRowsPerThread; ++ii) {
        const int i = ty * kRowsPerThread + ii;
        if (i >= q) continue;
        const float e = s_ecum[i];
        T* yrow = y + ((static_cast<size_t>(bi) * l + c0 + i) * h + hi) * p;
#pragma unroll
        for (int jj = 0; jj < MC; ++jj) {
          if (jj < pj) store(&yrow[tx + 16 * jj], yi[ii][jj] + e * yo[ii][jj]);
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // S = exp(total) S + sum_j w_j B_j (outer) (x dt)_j; thread: rows ty + 16kk, cols tx + 16jj
    {
      float acc[MC][MC];
#pragma unroll
      for (int kk = 0; kk < MC; ++kk)
#pragma unroll
        for (int jj = 0; jj < MC; ++jj) acc[kk][jj] = 0.0f;
      for (int j = 0; j < kChunk; ++j) {
        const float w = s_w[j];
        float bv[MC], xv[MC];
#pragma unroll
        for (int kk = 0; kk < MC; ++kk) bv[kk] = kk < nj ? w * s_b[j * ns + ty + 16 * kk] : 0.0f;
#pragma unroll
        for (int jj = 0; jj < MC; ++jj) xv[jj] = jj < pj ? s_x[j * p + tx + 16 * jj] : 0.0f;
#pragma unroll
        for (int kk = 0; kk < MC; ++kk)
#pragma unroll
          for (int jj = 0; jj < MC; ++jj) acc[kk][jj] = fmaf(bv[kk], xv[jj], acc[kk][jj]);
      }
      const float et = expf(total);
#pragma unroll
      for (int kk = 0; kk < MC; ++kk) {
        if (kk >= nj) continue;
#pragma unroll
        for (int jj = 0; jj < MC; ++jj) {
          if (jj >= pj) continue;
          float* sp = &s_st[(ty + 16 * kk) * p + tx + 16 * jj];
          *sp = et * *sp + acc[kk][jj];
        }
      }
    }
  }
  __syncthreads();
  float* out = state + static_cast<size_t>(blockIdx.x) * n * p;
  for (int idx = tid; idx < n * p; idx += kThreads) out[idx] = s_st[idx];
}

template <typename T, int MC>
cudaError_t launch(const void* x, const float* dt, const float* a, const void* bm, const void* cm,
                   void* y, float* state, int bsz, int l, int h, int p, int n,
                   cudaStream_t stream) {
  const int smem = smem_floats(n, p) * static_cast<int>(sizeof(float));
  auto kernel = ssd_kernel<T, MC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<bsz * h, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), state, l, h, p, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cols(const void* x, const float* dt, const float* a, const void* bm,
                        const void* cm, void* y, float* state, int bsz, int l, int h, int p,
                        int n, cudaStream_t stream) {
  const int cols = (p > n ? p : n) / 16;
  if (cols <= 1) return launch<T, 1>(x, dt, a, bm, cm, y, state, bsz, l, h, p, n, stream);
  if (cols <= 2) return launch<T, 2>(x, dt, a, bm, cm, y, state, bsz, l, h, p, n, stream);
  if (cols <= 4) return launch<T, 4>(x, dt, a, bm, cm, y, state, bsz, l, h, p, n, stream);
  return launch<T, kMaxCols>(x, dt, a, bm, cm, y, state, bsz, l, h, p, n, stream);
}

}  // namespace

// bf16 != 0: x, B, C and y are bf16, else fp32; dt, a and the state are fp32.
// N and P are multiples of 16 up to 128.  Returns cudaGetLastError().
extern "C" int ssd_launch(const void* x, const void* dt, const void* a, const void* bm,
                          const void* cm, void* y, void* state, int bsz, int l, int h, int p,
                          int n, int bf16, void* stream) {
  if (p % 16 || n % 16 || p < 16 || n < 16 || p > 16 * kMaxCols || n > 16 * kMaxCols) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* st = static_cast<float*>(state);
  if (bf16) return launch_cols<__nv_bfloat16>(x, dtf, af, bm, cm, y, st, bsz, l, h, p, n, s);
  return launch_cols<float>(x, dtf, af, bm, cm, y, st, bsz, l, h, p, n, s);
}
