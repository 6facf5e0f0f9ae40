// One step's arrival draws for a batch of Chargax envs, in one launch (sm_90a).
//
// Replaces no TPU kernel: the JAX package draws its arrivals with
// jax.random inside the jitted step (src/repro/core/transition.py:567-578),
// which XLA fuses.  The port's plain version,
// src/repro_torch/kernels/arrivals/ref.py, makes the same draws with eight
// library calls and their copies (a multinomial over a (B, M) expanded
// matrix, which renormalises and scans every row, two normals, two gammas
// over copied per-port fields, a Bernoulli and the Poisson count), 24
// kernels and about 2.27 ms a step at 262144 envs x 17 ports on an NVIDIA
// H100 80GB HBM3.
//
// What bounds it on the card: the bytes it writes, 4 B + 21 B N (an int32
// count per env; an int64 model, three float32 draws and a bool per port),
// 89.1 MB at 262144 envs x 16 ports (paper_16), 0.027 ms at 3.35 TB/s; the
// inputs (the clock, the day, the probability rows and per-port fields) are
// a few MB.  It does not reach that bound: its arithmetic (two Philox
// blocks, two Box-Muller pairs, the gammas' rejection loop and the model's
// walk, some hundreds of dependent instructions a thread) holds it at about
// 0.18 ms on an NVIDIA H100 80GB HBM3 at 700 W, against the plain version's
// 2.23 ms.
// The design:
//   * one thread per (env, port), consecutive threads on consecutive ports,
//     so every store is coalesced, and one more per env for its count, so
//     that no warp of port draws waits on a count's loop;
//   * the two gammas of a port's Beta draw in one rejection loop, so that a
//     warp waits on its lanes' rejections once;
//   * a Philox4x32-10 counter generator in registers, on its own
//     subsequence per thread (the thread's flat index) from the caller's
//     generator's seed and offset, laid out as curand_init(seed, thread,
//     offset) lays out its counter, so its bits never meet those of
//     PyTorch's own CUDA draws from the same generator.  A thread reads
//     about ten 32-bit values; the wrapper advances the generator's offset
//     by a budget of 64 a launch (ops.VALUES_PER_THREAD), which only a
//     rejection loop that runs on for tens of rounds, a vanishing chance,
//     would overrun;
//   * the car model walks the env's probability row once, normalised by the
//     row's sum as torch.multinomial normalises it, read through its strides
//     at [env_scenario,] day % rows: no scan, no (B, M) copy;
//   * the rate, the per-port Beta parameters and the time-sensitive share
//     are read through their strides where they lie, with no copy.
// The algorithms are exact: the count by inversion below a rate of 10 and
// by Hoermann's transformed rejection (PTRS, as numpy and PyTorch use) from
// 10 up; each gamma by Marsaglia and Tsang's method with the boost below a
// shape of 1, as ATen's sample_gamma, in float32, clamped to the least
// normal float as ATen's CUDA gamma is; Box-Muller normals.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr double kInversionBelow = 10.0;  // numpy's and PyTorch's switch to PTRS

// Philox4x32-10 (Salmon et al., SC'11), the counter generator of curand's
// Philox4_32_10_t.
__device__ __forceinline__ uint4 philox(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// A thread's stream: counter (offset / 4 + block, subsequence), four values
// a block, as curand_init(seed, subsequence, offset) with offset % 4 == 0.
struct Stream {
  uint2 key;
  uint4 ctr, out;
  int used;
  bool has_spare;
  float spare;

  __device__ Stream(unsigned long long seed, unsigned long long subsequence,
                    unsigned long long offset)
      : used(4), has_spare(false), spare(0.f) {
    key = make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
    const unsigned long long block = offset / 4;
    ctr = make_uint4(static_cast<uint32_t>(block), static_cast<uint32_t>(block >> 32),
                     static_cast<uint32_t>(subsequence),
                     static_cast<uint32_t>(subsequence >> 32));
  }

  __device__ uint32_t next() {
    if (used == 4) {
      out = philox(ctr, key);
      if (++ctr.x == 0) ++ctr.y;
      used = 0;
    }
    const int i = used++;
    return i == 0 ? out.x : i == 1 ? out.y : i == 2 ? out.z : out.w;
  }

  // float in [0, 1), 24 bits
  __device__ float uniform() { return static_cast<float>(next() >> 8) * 0x1p-24f; }

  // float in (0, 1], as curand_uniform
  __device__ float uniform_open() {
    return fmaf(static_cast<float>(next()), 0x1p-32f, 0x1p-33f);
  }

  // double in (0, 1), 53 bits
  __device__ double uniform_double() {
    const uint32_t hi = next() >> 5, lo = next() >> 6;
    return (static_cast<double>(hi) * 67108864.0 + static_cast<double>(lo) + 0.5) * 0x1p-53;
  }

  // two independent standard normals (Box-Muller)
  __device__ float2 normal2() {
    const float r = sqrtf(-2.f * logf(uniform_open()));
    float s, c;
    sincospif(2.f * uniform(), &s, &c);
    return make_float2(r * c, r * s);
  }

  __device__ float normal() {
    if (has_spare) {
      has_spare = false;
      return spare;
    }
    const float2 z = normal2();
    spare = z.y;
    has_spare = true;
    return z.x;
  }
};

// One gamma's boost and Marsaglia-Tsang constants (ATen's sample_gamma):
// below alpha = 1 a draw of Gamma(alpha + 1) scaled by U^(1 / alpha).
struct GammaShape {
  float scale, d, c;
  bool zero;
};

__device__ GammaShape gamma_shape(float alpha, Stream& g) {
  GammaShape s{1.f, 0.f, 0.f, alpha == 0.f};
  if (alpha < 1.f && !s.zero) {
    s.scale = powf(g.uniform_open(), 1.f / alpha);
    alpha += 1.f;
  }
  s.d = alpha - 1.f / 3.f;
  s.c = rsqrtf(9.f * s.d);
  return s;
}

// X ~ Gamma(a0) and Y ~ Gamma(a1), each by ATen's sample_gamma (Marsaglia
// and Tsang 2000) and clamped to the least normal float as ATen's CUDA gamma
// is, in one rejection loop: each round is one attempt at whichever is
// pending, so a warp runs two rounds and its lanes' rejections once, not
// once for each gamma in turn.
__device__ float2 gamma_pair(float a0, float a1, Stream& g) {
  GammaShape s = gamma_shape(a0, g);
  float first = 0.f;
  bool pending_second = false;
  for (;;) {
    float sample = 0.f;
    if (!s.zero) {
      const float x = g.normal();
      const float y = 1.f + s.c * x;
      if (y <= 0.f) continue;
      const float v = y * y * y;
      const float u = g.uniform_open();
      const float xx = x * x;
      if (!(u < 1.f - 0.0331f * xx * xx || logf(u) < 0.5f * xx + s.d * (1.f - v + logf(v)))) continue;
      sample = s.scale * s.d * v;
    }
    sample = fmaxf(sample, 1.17549435e-38f);
    if (pending_second) return make_float2(first, sample);
    first = sample;
    pending_second = true;
    s = gamma_shape(a1, g);
  }
}

// Poisson(lam): inversion below kInversionBelow, else PTRS (Hoermann 1993,
// numpy's random_poisson_ptrs).
__device__ int poisson_sample(double lam, Stream& g) {
  if (!(lam > 0.0)) return 0;
  if (lam < kInversionBelow) {
    const double u = g.uniform_double();
    double p = exp(-lam), cdf = p;
    int k = 0;
    while (u > cdf) {
      p *= lam / (k + 1);
      const double next = cdf + p;
      if (next == cdf) break;  // the tail rounds away: u lies within an ulp of 1
      cdf = next;
      ++k;
    }
    return k;
  }
  const double slam = sqrt(lam), loglam = log(lam);
  const double b = 0.931 + 2.53 * slam;
  const double a = -0.059 + 0.02483 * b;
  const double log_invalpha = log(1.1239 + 1.1328 / (b - 3.4));
  const double vr = 0.9277 - 3.6224 / (b - 2.0);
  for (;;) {
    const double u = g.uniform_double() - 0.5, v = g.uniform_double();
    const double us = 0.5 - fabs(u);
    const double k = floor((2.0 * a / us + b) * u + lam + 0.43);
    if (us >= 0.07 && v <= vr) return static_cast<int>(k);
    if (k < 0.0 || (us < 0.013 && v > us)) continue;
    if (log(v) + log_invalpha - log(a / (us * us) + b) <= -lam + k * loglam - lgamma(k + 1.0))
      return static_cast<int>(k);
  }
}

}  // namespace

// A clock-read table: the element at [scenario, row, col] lies at
// scen_stride * scenario + row_stride * (index % rows) + col_stride * col
// (scen_stride 0 without a scenario axis, row_stride 0 for one row).
struct ClockTable {
  const float* data;
  long long scen_stride, row_stride, col_stride;
  int rows, cols;
};

// A per-port field read through the strides of its (B, N) expanded view.
struct PortField {
  const float* data;
  long long env_stride, port_stride;
};

// Everything one launch reads and writes.  Outputs are contiguous; each
// per-env input is read at env * its stride (0: one value for all).
struct ArrivalArgs {
  int* m;                                      // (B,) int32 count
  long long* model;                            // (B, N) int64
  float *z_stay, *soc0, *z_tgt;                // (B, N)
  unsigned char* bern;                         // (B, N) bool
  const int* day;                              // (B,) day of the year
  const int* t;                                // (B,) step of the day: the count is drawn
  const int* counts;                           // (B,) given counts (copied), or null
  const float* rate_extra;                     // (B,) added rate, or null
  const long long* scenario;                   // (B,) env_scenario, or null
  long long day_stride, t_stride, counts_stride, extra_stride, scenario_stride;
  ClockTable rate, day_scale, probs;           // arrival_rate, arrival_day_scale, car_probs
  PortField soc0_a, soc0_b, p_time_sensitive;
  int n_envs, n_ports;
  unsigned long long seed, offset;
};

namespace {

__device__ __forceinline__ long long row_of(const ClockTable& tab, long long scen, int index) {
  int r = index % tab.rows;
  if (r < 0) r += tab.rows;
  return tab.scen_stride * scen + tab.row_stride * r;
}

__device__ __forceinline__ float port_value(const PortField& f, int b, int n) {
  return f.data[f.env_stride * b + f.port_stride * n];
}

// Thread i < B N: port n = i % N of env b = i / N, every per-port draw.
__device__ __forceinline__ void draw_port(const ArrivalArgs& a, int i) {
  const int b = i / a.n_ports, n = i - b * a.n_ports;
  const long long scen = a.scenario ? a.scenario[a.scenario_stride * b] : 0;
  Stream g(a.seed, static_cast<unsigned long long>(i), a.offset);

  // the car model: one uniform against the row's running sum
  const float* row = a.probs.data + row_of(a.probs, scen, a.day[a.day_stride * b]);
  const long long cs = a.probs.col_stride;
  float total = 0.f;
#pragma unroll 8
  for (int j = 0; j < a.probs.cols; ++j) total += row[cs * j];
  const float target = g.uniform() * total;
  float cum = 0.f;
  int pick = -1, last = 0;
  // the whole row, without a break: a warp's lanes stay together
#pragma unroll 8
  for (int j = 0; j < a.probs.cols; ++j) {
    const float p = row[cs * j];
    if (p > 0.f) {
      cum += p;
      last = j;
      if (pick < 0 && target < cum) pick = j;
    }
  }
  a.model[i] = pick >= 0 ? pick : last;  // rounding past the sum: the last possible model

  const float2 z = g.normal2();
  a.z_stay[i] = z.x;
  a.z_tgt[i] = z.y;
  // Beta(a, b) as X / (X + Y) with X ~ Gamma(a), Y ~ Gamma(b)
  const float2 xy = gamma_pair(port_value(a.soc0_a, b, n), port_value(a.soc0_b, b, n), g);
  a.soc0[i] = xy.x / (xy.x + xy.y);
  a.bern[i] = g.uniform() < port_value(a.p_time_sensitive, b, n);
}

// Thread B N + b: env b's count, copied or drawn at its rate.  The counts
// have threads of their own so that no warp of port draws waits on one.
__device__ __forceinline__ void draw_count(const ArrivalArgs& a, int b, int i) {
  if (a.counts) {
    a.m[b] = a.counts[a.counts_stride * b];
    return;
  }
  const long long scen = a.scenario ? a.scenario[a.scenario_stride * b] : 0;
  float rate = a.rate.data[row_of(a.rate, scen, a.t[a.t_stride * b])] *
               a.day_scale.data[row_of(a.day_scale, scen, a.day[a.day_stride * b])];
  if (a.rate_extra) rate += a.rate_extra[a.extra_stride * b];
  Stream g(a.seed, static_cast<unsigned long long>(i), a.offset);
  a.m[b] = poisson_sample(static_cast<double>(rate), g);
}

// At most 64 registers, four blocks an SM: the counts' double-precision
// rejection loop would take 76 and three.
__global__ void __launch_bounds__(kThreads, 4) arrivals_kernel(const ArrivalArgs a) {
  // B (N + 1) < 2^31 (the launcher's limit): 32-bit index arithmetic
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int ports = a.n_envs * a.n_ports;
  if (i < ports) {
    draw_port(a, i);
  } else if (i < ports + a.n_envs) {
    draw_count(a, i - ports, i);
  }
}

}  // namespace

// sizeof(ArrivalArgs), which the wrapper's ctypes mirror must equal.
extern "C" int arrivals_args_bytes() { return static_cast<int>(sizeof(ArrivalArgs)); }

// Launches the draws on `stream` and returns cudaGetLastError() as an int,
// which the Python wrapper raises on; cudaErrorInvalidValue for B (N + 1)
// threads of 2^31 or more.
extern "C" int arrivals_launch(const ArrivalArgs* args, void* stream) {
  const long long items = static_cast<long long>(args->n_envs) * (args->n_ports + 1);
  if (args->n_envs <= 0) return 0;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((items + kThreads - 1) / kThreads);
  arrivals_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
