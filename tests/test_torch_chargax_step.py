"""The port's fused step against the JAX package's, and the CUDA kernel
against its plain version.

On the CPU the port's ``fused_step`` runs its plain version
(``ref.fused_step_ref``); it is held against the JAX ``fused_step`` in Pallas
interpret mode and on its jnp ``ref``, sliced to the real poles (the JAX pack
is padded to 128 lanes), at rtol 1e-4 / atol 2e-4 — the tolerance the JAX
package holds its own Pallas kernel to (``tests/kernels/test_chargax_step.py``).

The kernel's order of operations is emulated here in plain PyTorch
(``_kernel_order``): the per-pole reciprocals, the Eq. 5 loads summed over
member poles in pole order, p_req summed per env in pole order, and the two
fast divisions (``__fdividef``, within 2 ulp of IEEE) taken 2 ulp off.  That
emulation is held to ``fused_step_ref`` at the same tolerance, over the
bundled layouts and a padded fleet station of 41 poles and 36 nodes.

A fleet's stations differ in their packs (``PolePacks``: K packs and each
env's index, one launch): the plain version gathers each env's pack, held
here against each station's slice run alone with its own pack, and the
wrapper refuses an index out of range and K packs over a block's shared
memory before any launch.

The CUDA kernel cannot run here: its cases are marked ``cuda`` and skip
without a card.  They build their inputs from the port alone (numpy and a
seed), and JAX is imported only by the tests that compare with it, so the
``cuda`` cases also run where JAX is not installed.
"""
from __future__ import annotations

import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.core import ChargaxEnv, EnvConfig
from repro_torch.kernels.chargax_step import ops
from repro_torch.kernels.chargax_step.ref import BIG, FusedOut, PolePacks, PoleSlabs, fused_step_ref

TOL = dict(rtol=1e-4, atol=2e-4)
LAYOUTS = ("paper_16", "deep_4x4", "kiosk_ac_4")
# the bundled layouts, and paper_16 padded as a fleet pads it: 40 EVSEs and
# the battery (P = 41) under 36 nodes
CONFIGS = {
    **{name: dict(architecture=name) for name in LAYOUTS},
    "padded_41x36": dict(pad_evse=40, pad_nodes=36),
}
DT = 5 / 60


@functools.cache
def _jax():
    """jax and the JAX-side helpers, imported when a test needs them: the
    CUDA cases also run where JAX is not installed."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import test_torch_transition as tt
    from repro.kernels.chargax_step import ops as jax_ops

    return types.SimpleNamespace(jax=jax, jnp=jnp, ops=jax_ops, tt=tt)


@functools.cache
def _jax_fused_step(impl: str):
    j = _jax()
    jenv, _ = j.tt.env_pair()
    fn = functools.partial(
        j.ops.fused_step, dt_hours=jenv.config.dt_hours, impl=impl, block_envs=64
    )
    return j.jax.jit(lambda p, s, te, tb, cap: fn(p, s, te, tb, cap_kw=cap))


def _inputs(b: int, seed: int, architecture: str = "paper_16"):
    tt = _jax().tt
    jenv, tenv = tt.env_pair(architecture)
    rng = np.random.default_rng(seed)
    fields = tt.random_state_fields(rng, jenv, b)
    params = jenv.default_params
    n = jenv.n_evse
    te = (rng.uniform(-1, 1, (b, n)) * np.asarray(params.evse_max_current)).astype(np.float32)
    tb = (rng.uniform(-1, 1, b) * float(params.batt_max_current)).astype(np.float32)
    return jenv, tenv, fields, te, tb


@functools.cache
def _env(config: str) -> ChargaxEnv:
    return ChargaxEnv(EnvConfig(fused_step=True, **CONFIGS[config]), device="cpu")


def _random_slabs(env: ChargaxEnv, b: int, seed: int) -> PoleSlabs:
    """Random (B, P) pole slabs on the CPU: EVSE poles, then the battery pole
    with its unbounded request."""
    rng = np.random.default_rng(seed)
    p = env.default_params
    n = env.n_evse
    imax = np.append(p.evse_max_current.numpy(), float(p.batt_max_current))
    occ = (rng.random((b, n + 1)) < 0.7).astype(np.float32)
    occ[:, n] = 1.0
    e_remain = rng.uniform(0.0, 40.0, (b, n + 1)) * (rng.random((b, n + 1)) < 0.9)
    e_remain[:, n] = BIG
    cap = 40.0 + 60.0 * rng.random((b, n + 1))
    cap[:, n] = float(p.batt_capacity)
    rbar = 50.0 + 250.0 * rng.random((b, n + 1))
    rbar[:, n] = float(p.batt_max_current)
    tau = 0.6 + 0.3 * rng.random((b, n + 1))
    tau[:, n] = float(p.batt_tau)
    cols = dict(
        target=rng.uniform(-1.0, 1.0, (b, n + 1)) * imax,
        occupied=occ,
        soc=rng.uniform(0.02, 0.98, (b, n + 1)),
        e_remain=e_remain,
        cap=cap,
        rbar=rbar,
        tau=tau,
    )
    return PoleSlabs(**{k: torch.from_numpy(v.astype(np.float32)) for k, v in cols.items()})


def _binding_cap(slabs: PoleSlabs, pp) -> torch.Tensor:
    """Half of each env's requested power: binds wherever an env draws."""
    return 0.5 * fused_step_ref(slabs, pp, DT).p_req.clamp_min(1.0)


def _two_ulps_up(x: torch.Tensor) -> torch.Tensor:
    """``x`` two float32 steps towards +inf: the most ``__fdividef`` may be
    off an IEEE division in the kernel's range."""
    up = torch.full_like(x, float("inf"))
    return torch.nextafter(torch.nextafter(x, up), up)


def _kernel_order(slabs: PoleSlabs, pp, dt_hours: float, cap: torch.Tensor) -> FusedOut:
    """The CUDA kernel's arithmetic, operation for operation, in float32; its
    two fast divisions as IEEE divisions taken 2 ulp up."""
    s, er, cp, rb, ta = slabs.soc, slabs.e_remain, slabs.cap, slabs.rbar, slabs.tau
    occ = slabs.occupied
    dt = torch.tensor(dt_hours, dtype=torch.float32)  # the kernel takes dt as a float
    # per-pole constants, staged once per block
    amp_per_kwh = 1000.0 / (pp.voltage * dt).clamp_min(1e-9)
    inv_eff = 1.0 / pp.eff.clamp_min(1e-9)
    kwh_per_amp = pp.voltage * dt / 1000.0
    # per-pole bounds and clip, one reciprocal of (1 - tau) per item
    inv_tau = _two_ulps_up(1.0 / (1.0 - ta).clamp_min(1e-6))
    sd = 1.0 - s
    rhat_chg = torch.where(s <= ta, rb, rb * (1.0 - s) * inv_tau)
    rhat_dis = torch.where(sd <= ta, rb, rb * (1.0 - sd) * inv_tau)
    amp_req = er * amp_per_kwh
    amp_soc = (1.0 - s) * cp * amp_per_kwh * inv_eff
    amp_dis = s * cp * pp.eff * amp_per_kwh
    up = torch.minimum(torch.minimum(rhat_chg, pp.imax), torch.minimum(amp_req, amp_soc))
    down = -torch.minimum(torch.minimum(rhat_dis, pp.imax), amp_dis)
    i = torch.minimum(torch.maximum(slabs.target, down), up.clamp_min(0.0)) * occ
    # Eq. 5: each (env, node) sums its member poles in pole order
    mag = i.abs()
    load = torch.zeros(i.shape[0], pp.member.shape[0])
    for p in range(i.shape[1]):
        load = load + pp.member[:, p] * mag[:, p : p + 1]
    s_node = torch.clamp(pp.node_budget / load.clamp_min(1e-9), max=1.0)
    over = (load - pp.node_budget).clamp_min(0.0)
    scale = torch.ones_like(i)
    for n in range(pp.member.shape[0]):
        scale = torch.where(pp.member[n] > 0, torch.minimum(scale, s_node[:, n : n + 1]), scale)
    i = i * scale
    # feeder envelope: p_req summed per env in pole order
    w = i.clamp_min(0.0) * pp.power_w
    total = torch.zeros(i.shape[0])
    for p in range(i.shape[1]):
        total = total + w[:, p]
    p_req = total / 1000.0
    excess = torch.zeros(i.shape[0])
    for n in range(pp.member.shape[0]):
        excess = torch.maximum(excess, over[:, n])
    gscale = torch.clamp(cap / p_req.clamp_min(1e-9), max=1.0)
    i = torch.where(i > 0.0, i * gscale[:, None], i)
    # integrate over dt
    e = i * kwh_per_amp
    soc_delta = torch.where(e >= 0.0, e * pp.eff, e * inv_eff)
    soc_new = torch.clamp(s + _two_ulps_up(soc_delta / cp.clamp_min(1e-6)), 0.0, 1.0)
    headroom = torch.where(er >= 0.5 * BIG, BIG, (1.0 - soc_new) * cp)
    er_new = torch.minimum((er - e).clamp_min(0.0), headroom)
    rhat = torch.where(soc_new <= ta, rb, rb * (1.0 - soc_new) * inv_tau) * occ
    return FusedOut(i, soc_new, er_new, rhat, e, excess, p_req)


@pytest.mark.parametrize("finite_cap", [True, False], ids=["cap", "unlimited"])
@pytest.mark.parametrize("batch", [1, 64, 300])
@pytest.mark.parametrize("impl", ["interpret", "ref"])
def test_fused_step_matches_jax(impl, batch, finite_cap):
    j = _jax()
    jenv, tenv, fields, te, tb = _inputs(batch, seed=batch)
    cap = np.full(batch, 60.0 if finite_cap else BIG, np.float32)
    want = _jax_fused_step(impl)(
        jenv.default_params, j.tt.jax_state(fields), te, tb, j.jnp.asarray(cap)
    )
    got = ops.fused_step(
        tenv.default_params,
        j.tt.torch_state(fields),
        torch.from_numpy(te),
        torch.from_numpy(tb),
        jenv.config.dt_hours,
        cap_kw=torch.from_numpy(cap) if finite_cap else None,
    )
    p = jenv.n_evse + 1
    for name, g, w in zip(FusedOut._fields, got, want):
        w = np.asarray(w)
        w = w[..., :p] if g.dim() == 2 else w
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
    if finite_cap:
        assert np.any(np.asarray(want.p_req) > 60.0)  # the cap binds somewhere


@pytest.mark.parametrize("architecture", LAYOUTS + ("single_ac_16", "mixed_8_8"))
def test_pole_pack_is_the_unpadded_jax_pack(architecture):
    j = _jax()
    jenv, tenv = j.tt.env_pair(architecture)
    jp = j.ops.build_pole_params(jenv.default_params)
    tp = ops.build_pole_params(tenv.default_params)
    p, nn = tenv.n_evse + 1, tenv.default_params.member.shape[0]
    for name in ("voltage", "imax", "eff", "power_w"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name))[:p])
    np.testing.assert_array_equal(tp.member.numpy(), np.asarray(jp.member)[:nn, :p])
    np.testing.assert_array_equal(tp.node_budget.numpy(), np.asarray(jp.node_budget)[:nn])
    # the kernel reads membership as this (Nn, P) float32 0/1 matrix
    assert tp.member.dtype == torch.float32 and tp.member.is_contiguous()
    assert set(np.unique(tp.member.numpy())) <= {0.0, 1.0}


@pytest.mark.parametrize("finite_cap", [True, False], ids=["cap", "unlimited"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_kernel_arithmetic_emulation_stays_within_tolerance(config, finite_cap):
    env = _env(config)
    pp = env.default_params.pole
    slabs = _random_slabs(env, 300, seed=7)
    cap = _binding_cap(slabs, pp) if finite_cap else None
    want = fused_step_ref(slabs, pp, DT, cap)
    got = _kernel_order(slabs, pp, DT, torch.full((300,), BIG) if cap is None else cap)
    for name, g, w in zip(FusedOut._fields, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **TOL)
    if finite_cap:
        assert bool((want.p_req > cap).any())  # the cap binds somewhere
    # the emulation takes other roundings than the plain version somewhere
    assert any(not torch.equal(g, w) for g, w in zip(got, want))


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    tt = _jax().tt
    _, tenv, fields, te, tb = _inputs(16, seed=3)
    params = tenv.default_params
    before = ops.chargax_step.launches
    got = ops.fused_step(
        params, tt.torch_state(fields), torch.from_numpy(te), torch.from_numpy(tb), DT
    )
    slabs = ops.build_slabs(params, tt.torch_state(fields), torch.from_numpy(te), torch.from_numpy(tb))
    want = fused_step_ref(slabs, ops.build_pole_params(params), DT)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert ops.chargax_step.launches == before
    # an unlimited cap of BIG is the no-cap path, bit for bit
    big = fused_step_ref(slabs, ops.build_pole_params(params), DT, torch.full((16,), BIG))
    for g, w in zip(big, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_wrapper_refuses_other_devices():
    env = _env("paper_16")
    # a meta tensor launches nothing: its branch returns empty outputs
    meta = PoleSlabs(*(x.to("meta") for x in _random_slabs(env, 2, seed=4)))
    before = ops.chargax_step.launches
    out = ops.chargax_step(meta, env.default_params.pole, DT)
    assert [o.device.type for o in out] == ["meta"] * 7 and out.current.shape == meta.target.shape
    assert ops.chargax_step.launches == before


# the fleet of benchmarks/fleet_throughput.py: 16/16/8 EVSEs and 3/5/1 nodes,
# padded to P = 17, Nn = 5
FLEET_ARCHS = ("paper_16", "deep_4x4", "single_dc_8")


@functools.cache
def _fleet_params(replicas: int):
    from repro_torch.core import FleetEnv

    fleet = FleetEnv(FLEET_ARCHS, EnvConfig(fused_step=True), replicas=replicas, device="cpu")
    return fleet.default_params


def _fleet_slabs(params, seed: int) -> PoleSlabs:
    """Random slabs for a fleet's envs: padded ports empty, the battery pole
    each station's own."""
    b, n = params.evse_mask.shape
    env = _env("paper_16")
    rows = _random_slabs(env, b, seed)  # (B, 17): paper_16 and the fleet share P
    batt = dict(cap=params.batt_capacity, rbar=params.batt_max_current, tau=params.batt_tau)
    mask = torch.cat([params.evse_mask, torch.ones(b, 1)], dim=1)
    out = {}
    for name, x in zip(PoleSlabs._fields, rows):
        x = x.clone()
        if name in batt:
            x[:, n] = batt[name]
        if name == "occupied":
            x = x * mask
        out[name] = x
    return PoleSlabs(**out)


def _station_caps(slabs: PoleSlabs, pp: PolePacks) -> torch.Tensor:
    """Per-station caps at 0.3, 0.5 and 0.7 of each env's requested power:
    they bind wherever a station draws, each at its own fraction."""
    frac = torch.tensor([0.3, 0.5, 0.7])[pp.index.long()]
    return frac * fused_step_ref(slabs, pp, DT).p_req.clamp_min(1.0)


@pytest.mark.parametrize("finite_cap", [True, False], ids=["cap", "unlimited"])
def test_pole_packs_are_each_stations_own_pack(finite_cap):
    """A 3-station fleet through one call of the plain version with a pack
    per env equals each station's envs run alone with its own pack."""
    from repro_torch.core import FleetEnv

    params = _fleet_params(4)
    pp = params.pole
    assert isinstance(pp, PolePacks) and pp.packs.member.shape == (3, 5, 17)
    assert pp.index.tolist() == [0, 1, 2] * 4 and pp.index.dtype == torch.int32
    slabs = _fleet_slabs(params, seed=3)
    cap = _station_caps(slabs, pp) if finite_cap else None
    got = ops.chargax_step(slabs, pp, DT, cap)
    fleet = FleetEnv(FLEET_ARCHS, EnvConfig(fused_step=True), device="cpu")
    for s in range(3):
        rows = torch.arange(s, 12, 3)
        alone = fused_step_ref(
            PoleSlabs(*(x[rows] for x in slabs)),
            fleet.station_params(s).pole,
            DT,
            None if cap is None else cap[rows],
        )
        for name, g, w in zip(FusedOut._fields, got, alone):
            torch.testing.assert_close(g[rows], w, rtol=0, atol=0, msg=name)
    if finite_cap:
        assert bool((got.p_req > cap).all())


def test_kernel_wrapper_refuses_a_pack_index_out_of_range():
    """A pack index out of [0, K) or not (B,) int32 is refused where the
    packs are made, and one of another batch by the wrapper before a
    launch."""
    params = _fleet_params(2)
    slabs = _fleet_slabs(params, seed=4)
    packs = params.pole.packs
    for bad in ([0, 1, 2, 0, 1, 3], [0, 1, 2, 0, -1, 2]):
        with pytest.raises(ValueError, match="pack index out of range"):
            PolePacks(packs, torch.tensor(bad, dtype=torch.int32))
    with pytest.raises(ValueError, match="pack index must be"):
        PolePacks(packs, params.pole.index.long())
    other = PolePacks(packs, torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="pack index has shape"):
        ops._launch(slabs, other, DT, torch.ones(6))


def test_kernel_wrapper_refuses_packs_over_the_shared_memory_budget():
    """K packs fit beside the tiles or the wrapper refuses before a launch:
    at the largest P and Nn one pack fills the block, and 50 packs of the
    fleet's shape (P = 17, Nn = 5) fit."""
    assert ops.smem_bytes(ops.MAX_POLES, ops.MAX_NODES) == 200192
    assert ops.smem_bytes(ops.MAX_POLES, ops.MAX_NODES, 1) + 8 <= ops.SMEM_BYTES
    assert ops.smem_bytes(ops.MAX_POLES, ops.MAX_NODES, 2) + 8 > ops.SMEM_BYTES
    for k, p, nn in ((2, ops.MAX_POLES, ops.MAX_NODES), (1000, 17, 5)):
        slabs, one, cap = _slabs_and_pole(4, p, nn)
        pp = PolePacks(
            ops.PoleParams(*(x.expand(k, *x.shape).contiguous() for x in one)),
            torch.zeros(4, dtype=torch.int32),
        )
        with pytest.raises(ValueError, match="shared"):
            ops._launch(slabs, pp, DT, cap)
    slabs, one, cap = _slabs_and_pole(4, 17, 5)
    pp = PolePacks(
        ops.PoleParams(*(x.expand(50, *x.shape).contiguous() for x in one)),
        torch.zeros(4, dtype=torch.int32),
    )
    ops._check(slabs, pp, cap)


def _slabs_and_pole(b: int, p: int, nn: int, dtype=torch.float32):
    slabs = PoleSlabs(*(torch.ones((b, p), dtype=dtype) for _ in PoleSlabs._fields))
    pp = ops.PoleParams(
        voltage=torch.ones(p), imax=torch.ones(p), eff=torch.ones(p),
        member=torch.ones((nn, p)), node_budget=torch.ones(nn), power_w=torch.ones(p),
    )
    return slabs, pp, torch.ones(b)


@pytest.mark.parametrize("p, nn", [(ops.MAX_POLES + 1, 3), (17, ops.MAX_NODES + 1)])
def test_kernel_wrapper_refuses_more_than_32_poles_or_nodes(p, nn):
    """The wrapper refuses P > MAX_POLES or Nn > MAX_NODES before a launch
    (the name keeps the limit of 32 of the kernel's first, one-warp-per-env
    design)."""
    slabs, pp, cap = _slabs_and_pole(4, p, nn)
    limit = f"at most {ops.MAX_POLES} poles and {ops.MAX_NODES} nodes"
    with pytest.raises(ValueError, match=limit):
        ops._launch(slabs, pp, DT, cap)


@pytest.mark.parametrize("p, nn", [(41, 36), (ops.MAX_POLES, ops.MAX_NODES)])
def test_kernel_wrapper_takes_padded_fleet_stations(p, nn):
    assert ops.MAX_POLES >= 41 and ops.MAX_NODES >= 36  # pad_evse=40, pad_nodes=36
    slabs, pp, cap = _slabs_and_pole(4, p, nn)
    ops._check(slabs, pp, cap)  # raises on what the kernel does not take


def test_kernel_wrapper_copies_only_misaligned_slabs():
    buf = torch.arange(4 * 17 + 4, dtype=torch.float32)
    aligned = buf[: 4 * 17].view(4, 17)
    assert ops._aligned(aligned) is aligned
    for offset in (1, 2, 3):  # 4, 8 and 12 bytes off a 16-byte boundary
        view = buf[offset : offset + 4 * 17].view(4, 17)
        got = ops._aligned(view)
        assert got.data_ptr() % 16 == 0 and got.data_ptr() != view.data_ptr()
        torch.testing.assert_close(got, view, rtol=0, atol=0)


def test_kernel_wrapper_checks_dtype_and_shape_before_launch():
    slabs, pp, cap = _slabs_and_pole(4, 17, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        ops._launch(slabs, pp, DT, cap)
    slabs, pp, _ = _slabs_and_pole(4, 17, 3)
    with pytest.raises(ValueError, match="cap_kw has shape"):
        ops._launch(slabs, pp, DT, torch.ones(5))
    with pytest.raises(ValueError, match="member has shape"):
        ops._launch(slabs, pp._replace(member=torch.ones(3, 16)), DT, cap)
    before = ops.chargax_step.launches
    slabs = PoleSlabs(*(x.t().contiguous().t() for x in slabs))  # column-major
    with pytest.raises(ValueError, match="not contiguous"):
        ops._launch(slabs, pp, DT, torch.ones(4))
    assert ops.chargax_step.launches == before


def _on_card(slabs: PoleSlabs, pp, cap):
    dev = torch.device("cuda")
    if isinstance(pp, PolePacks):
        pp_d = PolePacks(ops.PoleParams(*(x.to(dev) for x in pp.packs)), pp.index.to(dev))
    else:
        pp_d = type(pp)(*(x.to(dev) for x in pp))
    return PoleSlabs(*(x.to(dev) for x in slabs)), pp_d, None if cap is None else cap.to(dev)


def _assert_kernel_matches(slabs: PoleSlabs, pp, cap) -> None:
    want = fused_step_ref(slabs, pp, DT, cap)
    before = ops.chargax_step.launches
    slabs_d, pp_d, cap_d = _on_card(slabs, pp, cap)
    got = ops.chargax_step(slabs_d, pp_d, DT, cap_d)
    torch.cuda.synchronize()
    assert ops.chargax_step.launches == before + 1
    for name, g, w in zip(FusedOut._fields, got, want):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), err_msg=name, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 300, 16384])
@pytest.mark.parametrize("architecture", list(CONFIGS))
def test_cuda_kernel_matches_plain_version(architecture, batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chargax_step kernel has no CPU mode")
    env = _env(architecture)
    pp = env.default_params.pole
    slabs = _random_slabs(env, batch, seed=5)
    for cap in (None, _binding_cap(slabs, pp)):
        _assert_kernel_matches(slabs, pp, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [64, 300])
def test_cuda_kernel_at_the_largest_poles_and_nodes(batch):
    """P = MAX_POLES, Nn = MAX_NODES with a random tree-like membership:
    every pole under the root node, each also under a few others."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chargax_step kernel has no CPU mode")
    p, nn = ops.MAX_POLES, ops.MAX_NODES
    rng = np.random.default_rng(11)
    member = (rng.random((nn, p)) < 0.1).astype(np.float32)
    member[0] = 1.0
    env = _env("paper_16")
    base = env.default_params.pole
    reps = -(-p // base.voltage.shape[0])

    def tile(x: torch.Tensor) -> torch.Tensor:
        return x.repeat(reps)[:p].contiguous()

    pp = base._replace(
        voltage=tile(base.voltage), imax=tile(base.imax), eff=tile(base.eff),
        power_w=tile(base.power_w), member=torch.from_numpy(member),
        node_budget=torch.from_numpy(rng.uniform(100.0, 3000.0, nn).astype(np.float32)),
    )
    small = _random_slabs(env, batch * reps, seed=batch)
    slabs = PoleSlabs(*(x.reshape(batch, -1)[:, :p].contiguous() for x in small))
    for cap in (None, _binding_cap(slabs, pp)):
        _assert_kernel_matches(slabs, pp, cap)


@pytest.mark.cuda
def test_cuda_kernel_copies_misaligned_slabs_and_runs_in_one_wave():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chargax_step kernel has no CPU mode")
    env = _env("paper_16")
    pp = env.default_params.pole
    slabs = _random_slabs(env, 300, seed=6)
    want = fused_step_ref(slabs, pp, DT)
    dev = torch.device("cuda")
    views = []
    for x in slabs:  # each slab 4 bytes off a 16-byte boundary
        buf = torch.empty(x.numel() + 1, device=dev)
        buf[1:] = x.flatten().to(dev)
        views.append(buf[1:].view(x.shape))
    assert all(v.data_ptr() % 16 == 4 for v in views)
    got = ops.chargax_step(PoleSlabs(*views), _on_card(slabs, pp, None)[1], DT)
    torch.cuda.synchronize()
    for name, g, w in zip(FusedOut._fields, got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), err_msg=name, **TOL)
    per_sm, blocks = ops.blocks_per_sm(16384, 17, 3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert blocks <= per_sm * sms, (per_sm, sms, blocks)


@pytest.mark.cuda
def test_cuda_stacked_scenarios_step_through_the_kernel():
    """A scenario stack on the card (the V2G mix with a 300 kW feeder
    world in place of its fourth) launches the kernel once a step, with
    per-env caps that bind in one scenario's envs, and agrees with the same
    stack stepped on the CPU on the same actions and draws."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chargax_step kernel has no CPU mode")
    from repro_torch import scenarios
    from repro_torch.core import sampling
    from repro_torch.utils import replace

    names = scenarios.V2G_MIXED_PACK[:3] + ("grid_tight_transformer",)
    config = EnvConfig(allow_v2g=True, fused_step=True)
    envs = [ChargaxEnv(config, device=d) for d in ("cuda", "cpu")]
    params = [
        scenarios.expand_params(
            scenarios.stack_params([scenarios.make(n).make_params(e) for n in names]), 16
        )
        for e in envs
    ]
    gen = torch.Generator().manual_seed(7)
    reset = sampling.draw_reset(params[1], 16, gen)
    (_, state_d), (_, state_c) = (
        e.reset(sampling.ResetDraws(day=reset.day.to(e.device)), p) for e, p in zip(envs, params)
    )
    # from midday, when the 300 kW feeder binds
    state_d, state_c = (replace(s, t=s.t + 144) for s in (state_d, state_c))
    violation = torch.zeros(16)
    for step in range(12):
        action = torch.randint(10, 21, (16, envs[1].num_action_heads), generator=gen)
        draws = sampling.draw_arrivals(params[1], state_c, gen)
        before = ops.chargax_step.launches
        ts_d = envs[0].step(
            sampling.ArrivalDraws(**{k: getattr(draws, k).cuda() for k in draws.__dataclass_fields__}),
            state_d, action.cuda(), params[0],
        )
        torch.cuda.synchronize()
        assert ops.chargax_step.launches == before + 1
        ts_c = envs[1].step(draws, state_c, action, params[1])
        for name in ("obs", "reward"):
            np.testing.assert_allclose(
                getattr(ts_d, name).cpu().numpy(), getattr(ts_c, name).numpy(),
                rtol=1e-4, atol=1e-3, err_msg=f"step {step} {name}",
            )
        violation += ts_c.info["grid/violation"]
        state_d, state_c = ts_d.state, ts_c.state
    assert (violation[12:] > 0).all() and (violation[:12] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [48, 16383])
def test_cuda_kernel_takes_a_heterogeneous_fleets_packs(batch):
    """The fleet of benchmarks/fleet_throughput.py (paper_16, deep_4x4,
    single_dc_8 padded to P = 17, Nn = 5; three packs) in one launch, with
    an unlimited cap and binding per-station caps, against the plain version;
    the packed instance's blocks per SM and waves at 16383 envs; the
    wrapper's shared-memory count equal to the kernel's own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chargax_step kernel has no CPU mode")
    for p, nn, k in ((17, 5, None), (17, 5, 3), (17, 5, 1000), (ops.MAX_POLES, ops.MAX_NODES, None),
                     (ops.MAX_POLES, ops.MAX_NODES, 2)):
        assert ops.smem_bytes(p, nn, k) == ops.kernel_smem_bytes(p, nn, k), (p, nn, k)
    params = _fleet_params(batch // 3)
    pp = params.pole
    slabs = _fleet_slabs(params, seed=batch)
    for cap in (None, _station_caps(slabs, pp)):
        _assert_kernel_matches(slabs, pp, cap)
    per_sm, blocks = ops.blocks_per_sm(batch, 17, 5, n_packs=3)
    sms = torch.cuda.get_device_properties(torch.device("cuda")).multi_processor_count
    assert blocks <= per_sm * sms, (per_sm, sms, blocks)
