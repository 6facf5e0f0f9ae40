// Fused Chargax station step for Hopper (sm_90a): request -> allocate -> deliver.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/chargax_step/kernel.py::_chargax_kernel (launched by
// chargax_fused_step).  Its plain PyTorch version is
// src/repro_torch/kernels/chargax_step/ref.py::fused_step_ref.  The kernel
// repeats that arithmetic with the TPU kernel's reciprocals (1 / (1 - tau)
// once per item, 1000 / (v dt) and 1 / eff once per pole and block), so the
// two agree to a few fp32 roundings.  1 / (1 - tau) and the SoC step's
// division by the capacity take the fast division (__fdividef, within 2 ulp;
// the IEEE ones cost 0.0007-0.0014 ms a launch at paper_16 on an NVIDIA H100
// 80GB HBM3 at 700 W); min(1, budget / load) and min(1, cap / p_req), which
// decide what is curtailed, stay IEEE divisions.
//
// What bounds it on the card: HBM bytes.  Per env and launch it reads seven
// (P,) float32 slabs and one cap, and writes five (P,) slabs plus excess and
// p_req: at P = 17 (paper_16) that is (7 + 5) * 17 * 4 + 3 * 4 = 828 bytes for
// a few hundred flops, far below the card's flop/byte balance.  The design
// keeps every thread busy and the copies wide:
//   * a flat (env, pole) layout: a block owns kEnvsPerBlock consecutive envs,
//     whose rows of each slab are one contiguous tile of kEnvsPerBlock * P
//     floats.  kEnvsPerBlock is a multiple of 4, so every tile starts on a
//     16-byte boundary whatever P is;
//   * the seven input tiles arrive in shared memory by Hopper's bulk copy
//     (cp.async.bulk, one mbarrier), and the five output tiles leave by bulk
//     store, while the threads stage the per-pole constants and the (Nn, P)
//     membership matrix.  The ragged last block, or a slab off 16-byte
//     alignment, copies element by element instead;
//   * the per-element stages (bounds, clip, node scale, curtailment,
//     integration) run one thread per (env, pole) item, so no thread idles
//     at P = 17;
//   * the Eq. 5 loads are one thread per (env, node), summing the node's
//     member poles in pole order out of shared memory, and p_req one thread
//     per env, so there are no shuffle chains; five __syncthreads a block.
// Measured, latency holds it at about 0.3 of that bound, not bytes: at
// 16384 envs the grid is one wave, so every block copies in, computes and
// copies out in turn, and the arithmetic does not overlap the copies (the
// copies alone take about 0.8 of the kernel's time, and inputs in L2 save
// under a tenth).
// A fleet's stations differ in their poles and nodes (padded to one P and
// Nn), so a batch may carry K packs of the per-pole constants, membership
// and budgets, and a (B,) int32 index of each env's pack: the packed
// instance stages all K packs and its 32 envs' indices in shared memory and
// reads each item's constants at its env's pack; the single-pack instance
// is the same code with the pack fixed at 0.  One launch serves the batch
// either way.
// P, Nn and K are bounded only by the shared memory a block may hold
// (smem_floats); the wrapper states the maxima it takes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;  // the battery pole's energy-request sentinel
constexpr int kThreads = 256;
constexpr int kEnvsPerBlock = 32;  // a multiple of 4: 16-byte aligned tiles
constexpr int kInputs = 7;
constexpr int kOutputs = 5;
// shared tiles of kEnvsPerBlock * P floats: the seven inputs (five of them
// overwritten in place by the outputs), a scratch tile and 1 / (1 - tau)
constexpr int kTiles = kInputs + 2;
constexpr int kScratch = kInputs, kInvTau = kInputs + 1;
constexpr int kTarget = 0, kOccupied = 1, kSoc = 2, kERemain = 3, kCap = 4, kRbar = 5, kTau = 6;
// per-pole constants, one row of P each: imax, eff, power_w, amps per kWh
// 1000 / max(v dt, 1e-9), 1 / max(eff, 1e-9) and kWh per amp v dt / 1000
constexpr int kImax = 0, kEff = 1, kPowerW = 2, kAmpPerKwh = 3, kInvEff = 4, kKwhPerAmp = 5;
constexpr int kPoleConsts = 6;

struct Slabs {
  const float* in[kInputs];  // target, occupied, soc, e_remain, cap, rbar, tau
  float* out[kOutputs];      // current, soc, e_remain, rhat, e_pole
};

// the input tile output s is written into: current over target, soc over soc,
// e_remain over e_remain, rhat over rbar, e_pole over occupied
__host__ __device__ constexpr int out_tile(int s) {
  return s == 0 ? kTarget : s == 1 ? kSoc : s == 2 ? kERemain : s == 3 ? kRbar : kOccupied;
}

// the floats of a block's shared memory: the tiles, K packs of per-pole
// constants, membership and budgets, the per-(env, node) scales and excesses,
// the per-env caps and feeder scales, and (packed) the per-env pack indices
__host__ __device__ constexpr int smem_floats(int n_poles, int n_nodes, int n_packs, bool packs) {
  return kTiles * kEnvsPerBlock * n_poles +
         n_packs * (kPoleConsts * n_poles + n_nodes * n_poles + n_nodes) +
         2 * kEnvsPerBlock * n_nodes + 2 * kEnvsPerBlock + (packs ? kEnvsPerBlock : 0);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(src), "r"(bytes)
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

template <bool kPacks>
__global__ void __launch_bounds__(kThreads)
chargax_step_kernel(
    Slabs slabs,
    const float* __restrict__ grid_cap,  // (B,) feeder cap [kW]
    // static pole and node parameters, one pack or K packs stacked
    const float* __restrict__ voltage, const float* __restrict__ imax,
    const float* __restrict__ eff, const float* __restrict__ power_w,  // (K, P)
    const float* __restrict__ member,       // (K, Nn, P) 0/1
    const float* __restrict__ node_budget,  // (K, Nn)
    const int* __restrict__ pack,           // (B,) each env's pack (kPacks)
    float* __restrict__ excess_out, float* __restrict__ p_req_out,  // (B,)
    int n_envs, int n_poles, int n_nodes, int n_packs, float dt_hours, int aligned) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar_storage;
  const int P = n_poles, Nn = n_nodes, K = kPacks ? n_packs : 1, tid = threadIdx.x;
  const int tile = kEnvsPerBlock * P;
  const int pack_floats = kPoleConsts * P;  // one pack's per-pole constants
  float* tiles = smem;  // kTiles tiles of `tile` floats
  float* pole = tiles + kTiles * tile;  // K packs of kPoleConsts rows of P
  float* mem = pole + K * pack_floats;  // (K, Nn, P)
  float* budget = mem + K * Nn * P;     // (K, Nn)
  float* s_node = budget + K * Nn;      // (kEnvsPerBlock, Nn)
  float* over = s_node + kEnvsPerBlock * Nn;
  float* cap_env = over + kEnvsPerBlock * Nn;  // (kEnvsPerBlock,)
  float* gscale = cap_env + kEnvsPerBlock;
  int* pack_env = reinterpret_cast<int*>(gscale + kEnvsPerBlock);  // (kEnvsPerBlock,) if kPacks

  const int e0 = blockIdx.x * kEnvsPerBlock;
  const int n_env = min(kEnvsPerBlock, n_envs - e0);
  const size_t base = static_cast<size_t>(e0) * P;
  const int items = n_env * P;
  const bool bulk = aligned && n_env == kEnvsPerBlock;  // the same for the whole block
  const uint32_t bar = smem_addr(&bar_storage);

  // --- tiles in: one bulk copy each, or element copies at the ragged edge ---
  if (bulk) {
    if (tid == 0) {
      const uint32_t bytes = static_cast<uint32_t>(tile) * 4u;
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(kInputs * bytes)
                   : "memory");
#pragma unroll
      for (int s = 0; s < kInputs; ++s) {
        bulk_load(smem_addr(tiles + s * tile), slabs.in[s] + base, bytes, bar);
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < kInputs; ++s) {
      for (int k = tid; k < items; k += kThreads) tiles[s * tile + k] = slabs.in[s][base + k];
    }
  }
  // per-pole constants and membership of every pack, staged while the
  // copies fly
  for (int q = tid; q < K * P; q += kThreads) {
    const int k = q / P, p = q - k * P;
    float* row = pole + k * pack_floats;
    const float v = voltage[q], ef = eff[q];
    row[kImax * P + p] = imax[q];
    row[kEff * P + p] = ef;
    row[kPowerW * P + p] = power_w[q];
    row[kAmpPerKwh * P + p] = 1000.0f / fmaxf(v * dt_hours, 1e-9f);
    row[kInvEff * P + p] = 1.0f / fmaxf(ef, 1e-9f);
    row[kKwhPerAmp * P + p] = v * dt_hours / 1000.0f;
  }
  for (int k = tid; k < K * Nn * P; k += kThreads) mem[k] = member[k];
  for (int n = tid; n < K * Nn; n += kThreads) budget[n] = node_budget[n];
  for (int e = tid; e < n_env; e += kThreads) {
    cap_env[e] = grid_cap[e0 + e];
    if (kPacks) pack_env[e] = pack[e0 + e];
  }
  __syncthreads();
  if (bulk) mbar_wait(bar, 0);

  // the (env, pole) of item k = tid + j * kThreads, stepped without division
  const int e_first = tid / P, p_first = tid - e_first * P;
  const int e_step = kThreads / P, p_step = kThreads - e_step * P;
#define FOR_ITEMS(k, e, p)                                                        \
  for (int k = tid, e = e_first, p = p_first; k < items;                        \
       k += kThreads, e += e_step + (p + p_step >= P), p += p_step - (p + p_step >= P) * P)

  float* const i_tile = tiles + kTarget * tile;
  float* const scratch = tiles + kScratch * tile;
  float* const inv_tau_tile = tiles + kInvTau * tile;

  // --- per-pole bounds and clip (transition.pole_bounds / pole_clip) -------
  FOR_ITEMS(k, e, p) {
    const float* pc = pole + (kPacks ? pack_env[e] : 0) * pack_floats;
    const float s = tiles[kSoc * tile + k], er = tiles[kERemain * tile + k];
    const float cp = tiles[kCap * tile + k], rb = tiles[kRbar * tile + k];
    const float ta = tiles[kTau * tile + k];
    const float im = pc[kImax * P + p], ef = pc[kEff * P + p];
    const float apk = pc[kAmpPerKwh * P + p], inv_eff = pc[kInvEff * P + p];
    const float inv_tau = __fdividef(1.0f, fmaxf(1.0f - ta, 1e-6f));
    const float sd = 1.0f - s;
    const float rhat_chg = s <= ta ? rb : rb * (1.0f - s) * inv_tau;
    const float rhat_dis = sd <= ta ? rb : rb * (1.0f - sd) * inv_tau;
    const float amp_req = er * apk;
    const float amp_soc = (1.0f - s) * cp * apk * inv_eff;
    const float amp_dis = s * cp * ef * apk;
    const float up = fminf(fminf(rhat_chg, im), fminf(amp_req, amp_soc));
    const float down = -fminf(fminf(rhat_dis, im), amp_dis);
    const float i = fminf(fmaxf(tiles[kTarget * tile + k], down), fmaxf(up, 0.0f)) *
                    tiles[kOccupied * tile + k];
    i_tile[k] = i;
    scratch[k] = fabsf(i);
    inv_tau_tile[k] = inv_tau;
  }
  __syncthreads();

  // --- Eq. 5: one thread per (env, node) sums its member poles -------------
  for (int j = tid; j < n_env * Nn; j += kThreads) {
    const int e = j / Nn, n = j - e * Nn;
    const int kn = (kPacks ? pack_env[e] * Nn : 0) + n;  // the node in its env's pack
    const float* a = scratch + e * P;
    const float* m = mem + kn * P;
    float load = 0.0f;
#pragma unroll 4
    for (int p = 0; p < P; ++p) load = fmaf(m[p], a[p], load);
    s_node[j] = fminf(1.0f, budget[kn] / fmaxf(load, 1e-9f));
    over[j] = fmaxf(load - budget[kn], 0.0f);
  }
  __syncthreads();

  // --- each pole takes the smallest scale of its member nodes --------------
  FOR_ITEMS(k, e, p) {
    const int pk = kPacks ? pack_env[e] : 0;
    const float* m = mem + pk * Nn * P;
    float scale = 1.0f;
#pragma unroll 4
    for (int n = 0; n < Nn; ++n) {
      if (m[n * P + p] > 0.0f) scale = fminf(scale, s_node[e * Nn + n]);
    }
    const float i = i_tile[k] * scale;
    i_tile[k] = i;
    scratch[k] = fmaxf(i, 0.0f) * pole[pk * pack_floats + kPowerW * P + p];
  }
  __syncthreads();

  // --- feeder envelope: one thread per env ---------------------------------
  for (int e = tid; e < n_env; e += kThreads) {
    const float* w = scratch + e * P;
    float sum = 0.0f;
#pragma unroll 4
    for (int p = 0; p < P; ++p) sum += w[p];
    const float p_req = sum / 1000.0f;
    float excess = 0.0f;
    for (int n = 0; n < Nn; ++n) excess = fmaxf(excess, over[e * Nn + n]);
    gscale[e] = fminf(1.0f, cap_env[e] / fmaxf(p_req, 1e-9f));
    excess_out[e0 + e] = excess;
    p_req_out[e0 + e] = p_req;
  }
  __syncthreads();

  // --- curtail charging amps and integrate over dt (pole_integrate) --------
  FOR_ITEMS(k, e, p) {
    const float* pc = pole + (kPacks ? pack_env[e] : 0) * pack_floats;
    float i = i_tile[k];
    if (i > 0.0f) i *= gscale[e];
    const float s = tiles[kSoc * tile + k], er = tiles[kERemain * tile + k];
    const float cp = tiles[kCap * tile + k], rb = tiles[kRbar * tile + k];
    const float ta = tiles[kTau * tile + k], occ = tiles[kOccupied * tile + k];
    const float e_kwh = i * pc[kKwhPerAmp * P + p];
    const float soc_delta =
        e_kwh >= 0.0f ? e_kwh * pc[kEff * P + p] : e_kwh * pc[kInvEff * P + p];
    const float soc_step = __fdividef(soc_delta, fmaxf(cp, 1e-6f));
    const float soc_new = fminf(fmaxf(s + soc_step, 0.0f), 1.0f);
    const float headroom = er >= 0.5f * kBig ? kBig : (1.0f - soc_new) * cp;
    const float rhat = soc_new <= ta ? rb : rb * (1.0f - soc_new) * inv_tau_tile[k];
    i_tile[k] = i;
    tiles[kSoc * tile + k] = soc_new;
    tiles[kERemain * tile + k] = fminf(fmaxf(er - e_kwh, 0.0f), headroom);
    tiles[kRbar * tile + k] = rhat * occ;
    tiles[kOccupied * tile + k] = e_kwh;
  }

  // --- tiles out: one bulk store each, or element stores -------------------
  if (bulk) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < kOutputs; ++s) {
        bulk_store(slabs.out[s] + base, smem_addr(tiles + out_tile(s) * tile),
                   static_cast<uint32_t>(items) * 4u);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // shared memory stays until the bulk stores have read it
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  } else {
    // each thread stores the items it wrote itself: no barrier needed
#pragma unroll
    for (int s = 0; s < kOutputs; ++s) {
      for (int k = tid; k < items; k += kThreads) {
        slabs.out[s][base + k] = tiles[out_tile(s) * tile + k];
      }
    }
  }
#undef FOR_ITEMS
}

// dynamic shared memory of one block, after raising the kernel's limit
// above the default 48 KB where it needs more; 0 if a block cannot hold it
template <bool kPacks>
size_t prepare(int n_poles, int n_nodes, int n_packs) {
  const size_t bytes =
      sizeof(float) * static_cast<size_t>(smem_floats(n_poles, n_nodes, n_packs, kPacks));
  int device = 0, limit = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
          cudaSuccess) {
    return 0;
  }
  // the static mbarrier takes 8 bytes of the same budget
  if (bytes + 8 > static_cast<size_t>(limit)) return 0;
  if (bytes > 48 * 1024 &&
      cudaFuncSetAttribute(chargax_step_kernel<kPacks>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes)) != cudaSuccess) {
    return 0;
  }
  return bytes;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <bool kPacks>
int occupancy(int n_envs, int n_poles, int n_nodes, int n_packs, int* per_sm, int* blocks) {
  const size_t smem = prepare<kPacks>(n_poles, n_nodes, n_packs);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = (n_envs + kEnvsPerBlock - 1) / kEnvsPerBlock;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, chargax_step_kernel<kPacks>, kThreads, smem));
}

template <bool kPacks>
int launch(const float* const in[kInputs], const float* grid_cap, const float* voltage,
           const float* imax, const float* eff, const float* power_w, const float* member,
           const float* node_budget, const int* pack, float* const out[kOutputs],
           float* excess_out, float* p_req_out, int n_envs, int n_poles, int n_nodes,
           int n_packs, float dt_hours, void* stream) {
  if (n_envs <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = prepare<kPacks>(n_poles, n_nodes, n_packs);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  Slabs slabs;
  bool aligned = true;
  for (int s = 0; s < kInputs; ++s) {
    slabs.in[s] = in[s];
    aligned = aligned && aligned16(in[s]);
  }
  for (int s = 0; s < kOutputs; ++s) {
    slabs.out[s] = out[s];
    aligned = aligned && aligned16(out[s]);
  }
  const unsigned blocks = (n_envs + kEnvsPerBlock - 1) / kEnvsPerBlock;
  chargax_step_kernel<kPacks><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      slabs, grid_cap, voltage, imax, eff, power_w, member, node_budget, pack, excess_out,
      p_req_out, n_envs, n_poles, n_nodes, n_packs, dt_hours, static_cast<int>(aligned));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The blocks of the kernel one SM holds at once at P poles and Nn nodes, and
// the blocks its grid has for n_envs envs.  Returns a CUDA error as an int.
extern "C" int chargax_step_occupancy(int n_envs, int n_poles, int n_nodes, int* per_sm,
                                      int* blocks) {
  return occupancy<false>(n_envs, n_poles, n_nodes, 1, per_sm, blocks);
}

// The same for the packed instance with n_packs packs in shared memory.
extern "C" int chargax_step_occupancy_packs(int n_envs, int n_poles, int n_nodes, int n_packs,
                                            int* per_sm, int* blocks) {
  return occupancy<true>(n_envs, n_poles, n_nodes, n_packs, per_sm, blocks);
}

// The dynamic shared memory of one block at P poles and Nn nodes, in bytes:
// the single-pack instance for n_packs <= 0, else the packed one with
// n_packs packs.  The wrapper's refusals are held against it.
extern "C" int chargax_step_smem_bytes(int n_poles, int n_nodes, int n_packs) {
  const bool packs = n_packs > 0;
  return static_cast<int>(sizeof(float)) *
         smem_floats(n_poles, n_nodes, packs ? n_packs : 1, packs);
}

// Launches the kernel with one pack for every env on `stream` and returns
// cudaGetLastError() as an int, which the Python wrapper raises on;
// cudaErrorInvalidValue if a block's shared memory cannot hold P poles and
// Nn nodes.
extern "C" int chargax_step_launch(
    const float* target, const float* occupied, const float* soc,
    const float* e_remain, const float* cap, const float* rbar, const float* tau,
    const float* grid_cap, const float* voltage, const float* imax,
    const float* eff, const float* power_w, const float* member,
    const float* node_budget, float* current_out, float* soc_out,
    float* e_remain_out, float* rhat_out, float* e_pole_out, float* excess_out,
    float* p_req_out, int n_envs, int n_poles, int n_nodes, float dt_hours,
    void* stream) {
  const float* in[kInputs] = {target, occupied, soc, e_remain, cap, rbar, tau};
  float* out[kOutputs] = {current_out, soc_out, e_remain_out, rhat_out, e_pole_out};
  return launch<false>(in, grid_cap, voltage, imax, eff, power_w, member, node_budget, nullptr,
                       out, excess_out, p_req_out, n_envs, n_poles, n_nodes, 1, dt_hours, stream);
}

// The same with n_packs packs stacked ((K, P) constants, (K, Nn, P)
// membership, (K, Nn) budgets) and `pack`, each env's pack in [0, n_packs);
// cudaErrorInvalidValue also if a block's shared memory cannot hold the
// packs.
extern "C" int chargax_step_launch_packs(
    const float* target, const float* occupied, const float* soc,
    const float* e_remain, const float* cap, const float* rbar, const float* tau,
    const float* grid_cap, const float* voltage, const float* imax,
    const float* eff, const float* power_w, const float* member,
    const float* node_budget, float* current_out, float* soc_out,
    float* e_remain_out, float* rhat_out, float* e_pole_out, float* excess_out,
    float* p_req_out, const int* pack, int n_packs, int n_envs, int n_poles, int n_nodes,
    float dt_hours, void* stream) {
  const float* in[kInputs] = {target, occupied, soc, e_remain, cap, rbar, tau};
  float* out[kOutputs] = {current_out, soc_out, e_remain_out, rhat_out, e_pole_out};
  return launch<true>(in, grid_cap, voltage, imax, eff, power_w, member, node_budget, pack, out,
                      excess_out, p_req_out, n_envs, n_poles, n_nodes, n_packs, dt_hours, stream);
}
