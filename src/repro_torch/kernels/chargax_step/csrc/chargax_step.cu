// Fused Chargax station step for Hopper (sm_90a): request -> allocate -> deliver.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/chargax_step/kernel.py::_chargax_kernel (launched by
// chargax_fused_step).  Its plain PyTorch version is
// src/repro_torch/kernels/chargax_step/ref.py::fused_step_ref, and this kernel
// repeats that arithmetic in the same order, so the two agree to fp32
// rounding (no fast-math: the divisions and min(1, budget/load) stay IEEE).
//
// What bounds it on the card: HBM bytes.  Per env and launch it reads seven
// (P,) float32 slabs and one cap, and writes five (P,) slabs plus excess and
// p_req: at P = 17 (paper_16) that is (7 + 5) * 17 * 4 + 3 * 4 = 828 bytes for
// a few hundred flops, far below the card's flop/byte balance.  The design
// moves each of those bytes once and nothing more:
//   * one warp per env, lane = pole (P <= 32), so the slabs are read with no
//     padding (the TPU version padded P to 128 lanes and the scalars to
//     (B, 128) rows, 7.5x the bytes at P = 17);
//   * all intermediates (bounds, clipped current, node loads, scales) stay in
//     registers; the Eq. 5 load of each node is a __shfl_xor warp sum over its
//     member lanes, with membership passed as one uint32 bitmask per node;
//   * the per-env scalars (cap in, excess and p_req out) are one float each.
// Lanes >= P idle (15 of 32 at P = 17); packing two envs per warp is left to
// a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;  // the battery pole's energy-request sentinel
constexpr int kWarp = 32;
constexpr int kEnvsPerBlock = 8;  // one warp per env

__device__ __forceinline__ float charge_rate(float soc, float rbar, float tau) {
  return soc <= tau ? rbar : rbar * (1.0f - soc) / fmaxf(1.0f - tau, 1e-6f);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, offset);
  }
  return x;
}

__global__ void __launch_bounds__(kEnvsPerBlock * kWarp)
chargax_step_kernel(
    // dynamic state slabs, all (B, P)
    const float* __restrict__ target, const float* __restrict__ occupied,
    const float* __restrict__ soc, const float* __restrict__ e_remain,
    const float* __restrict__ cap, const float* __restrict__ rbar,
    const float* __restrict__ tau,
    const float* __restrict__ grid_cap,  // (B,) feeder cap [kW]
    // static pole and node parameters
    const float* __restrict__ voltage, const float* __restrict__ imax,
    const float* __restrict__ eff, const float* __restrict__ power_w,  // (P,)
    const uint32_t* __restrict__ member_bits,  // (Nn,)
    const float* __restrict__ node_budget,     // (Nn,)
    // outputs: five (B, P) slabs and two (B,) scalars
    float* __restrict__ current_out, float* __restrict__ soc_out,
    float* __restrict__ e_remain_out, float* __restrict__ rhat_out,
    float* __restrict__ e_pole_out, float* __restrict__ excess_out,
    float* __restrict__ p_req_out,
    int n_envs, int n_poles, int n_nodes, float dt_hours) {
  const int lane = threadIdx.x % kWarp;
  const int env = blockIdx.x * kEnvsPerBlock + threadIdx.x / kWarp;
  if (env >= n_envs) return;  // uniform over the warp: shuffles stay full
  const bool live = lane < n_poles;
  const size_t at = static_cast<size_t>(env) * n_poles + lane;

  float tgt = 0.f, occ = 0.f, s = 0.f, er = 0.f, cp = 0.f, rb = 0.f, ta = 0.f;
  float v = 1.f, im = 0.f, ef = 1.f, pw = 0.f;
  if (live) {
    tgt = target[at];
    occ = occupied[at];
    s = soc[at];
    er = e_remain[at];
    cp = cap[at];
    rb = rbar[at];
    ta = tau[at];
    v = voltage[lane];
    im = imax[lane];
    ef = eff[lane];
    pw = power_w[lane];
  }

  // --- per-pole bounds and clip (transition.pole_bounds / pole_clip) -------
  const float rhat_chg = charge_rate(s, rb, ta);
  const float rhat_dis = charge_rate(1.0f - s, rb, ta);
  const float amp_req = er * 1000.0f / fmaxf(v * dt_hours, 1e-9f);
  const float amp_soc = (1.0f - s) * cp * 1000.0f / fmaxf(v * dt_hours * ef, 1e-9f);
  const float amp_dis = s * cp * ef * 1000.0f / fmaxf(v * dt_hours, 1e-9f);
  const float up = fminf(fminf(rhat_chg, im), fminf(amp_req, amp_soc));
  const float down = -fminf(fminf(rhat_dis, im), amp_dis);
  float i = live ? fminf(fmaxf(tgt, down), fmaxf(up, 0.0f)) * occ : 0.0f;

  // --- Eq. 5: node loads as warp sums, scale = min over member nodes -------
  const float mag = fabsf(i);
  float scale = 1.0f;
  float excess = 0.0f;
  for (int n = 0; n < n_nodes; ++n) {
    const bool member = (member_bits[n] >> lane) & 1u;
    const float load = warp_sum(member ? mag : 0.0f);
    const float budget = node_budget[n];
    const float s_node = fminf(1.0f, budget / fmaxf(load, 1e-9f));
    excess = fmaxf(excess, fmaxf(load - budget, 0.0f));
    if (member) scale = fminf(scale, s_node);
  }
  i *= scale;

  // --- feeder envelope: curtail charging amps only -------------------------
  const float p_req = warp_sum(fmaxf(i, 0.0f) * pw) / 1000.0f;
  const float gscale = fminf(1.0f, grid_cap[env] / fmaxf(p_req, 1e-9f));
  if (i > 0.0f) i *= gscale;

  // --- integrate over dt (transition.pole_integrate) -----------------------
  const float e = v * i * dt_hours / 1000.0f;
  const float soc_delta = e >= 0.0f ? e * ef : e / ef;
  const float soc_new = fminf(fmaxf(s + soc_delta / fmaxf(cp, 1e-6f), 0.0f), 1.0f);
  const float headroom = er >= 0.5f * kBig ? kBig : (1.0f - soc_new) * cp;
  const float er_new = fminf(fmaxf(er - e, 0.0f), headroom);
  const float rhat_new = charge_rate(soc_new, rb, ta) * occ;

  if (live) {
    current_out[at] = i;
    soc_out[at] = soc_new;
    e_remain_out[at] = er_new;
    rhat_out[at] = rhat_new;
    e_pole_out[at] = e;
  }
  if (lane == 0) {
    excess_out[env] = excess;
    p_req_out[env] = p_req;
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int,
// which the Python wrapper raises on.  Expects P <= 32 and Nn <= 32, checked
// by the wrapper.
extern "C" int chargax_step_launch(
    const float* target, const float* occupied, const float* soc,
    const float* e_remain, const float* cap, const float* rbar, const float* tau,
    const float* grid_cap, const float* voltage, const float* imax,
    const float* eff, const float* power_w, const uint32_t* member_bits,
    const float* node_budget, float* current_out, float* soc_out,
    float* e_remain_out, float* rhat_out, float* e_pole_out, float* excess_out,
    float* p_req_out, int n_envs, int n_poles, int n_nodes, float dt_hours,
    void* stream) {
  if (n_envs > 0) {
    const unsigned blocks = (n_envs + kEnvsPerBlock - 1) / kEnvsPerBlock;
    chargax_step_kernel<<<blocks, kEnvsPerBlock * kWarp, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        target, occupied, soc, e_remain, cap, rbar, tau, grid_cap, voltage, imax,
        eff, power_w, member_bits, node_budget, current_out, soc_out,
        e_remain_out, rhat_out, e_pole_out, excess_out, p_req_out, n_envs,
        n_poles, n_nodes, dt_hours);
  }
  return static_cast<int>(cudaGetLastError());
}
