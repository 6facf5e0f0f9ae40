"""The arrivals kernel: its route, its view of the inputs, its work, and on
the card the distributions of its draws.

On the CPU the sampler takes the plain version (``kernels/arrivals/ref.py``,
PyTorch's own samplers), held here to the library calls it always made, bit
for bit.  The launcher's reading of the inputs (the strides of the three
``car_probs`` layouts, of the clock tables and of the per-port fields) and
``work()``'s byte count are plain Python and are tested here too.

The kernel cannot run here: its cases are marked ``cuda`` and skip without a
card.  They hold its draws to the moments of their distributions at the
bounds of ``tests/test_torch_env.py``'s sampler tests, at 262144 envs (the
eval cell's batch) so that each bound is many standard errors wide.  The
file imports no JAX, so the ``cuda`` cases run on the card's machine.
"""
from __future__ import annotations

import math
import types

import numpy as np
import pytest
import torch

from repro_torch.core import ChargaxEnv, EnvConfig, sampling
from repro_torch.core.fleet import FleetEnv
from repro_torch.core.sampling import ArrivalDraws, ResetDraws
from repro_torch.core.state import per_port
from repro_torch.kernels.arrivals import ops
from repro_torch.utils import replace

Tensor = torch.Tensor
FLEET = (["paper_16", "deep_4x4", "single_dc_8"], ["shopping_pv_tou", "work_solar_summer", "highway_demand_charge"])
B_CARD = 262144


def _env(device: str = "cpu") -> ChargaxEnv:
    return ChargaxEnv(EnvConfig(fused_step=True), device=device)


def _fleet(device: str = "cpu", replicas: int = 2) -> FleetEnv:
    stations, scenarios = FLEET
    return FleetEnv(stations, EnvConfig(fused_step=True), scenarios=scenarios, replicas=replicas, device=device)


def _state(env, params, b: int, day: int | Tensor = 10, t: int = 150):
    """``b`` envs at step ``t`` of ``day``: one day for all, or a day each."""
    if isinstance(day, int):
        day = torch.full((b,), day, dtype=torch.int32)
    _, state = env.reset(ResetDraws(day=day.to(env.device, torch.int32)), params)
    return replace(state, t=torch.full((b,), t, dtype=torch.int32, device=env.device))


def _library_cars(params, day, n, m, gen) -> ArrivalDraws:
    """The library calls the sampler has always made for the per-port
    draws, written out."""
    b = day.shape[0]
    model = torch.multinomial(sampling.car_probs(params, day), n, replacement=True, generator=gen)
    z_stay = torch.randn((b, n), generator=gen)

    def ports(field):
        return per_port(field).expand(b, n).contiguous()

    x = torch._standard_gamma(ports(params.soc0_a), generator=gen)
    y = torch._standard_gamma(ports(params.soc0_b), generator=gen)
    z_tgt = torch.randn((b, n), generator=gen)
    bern = torch.bernoulli(ports(params.p_time_sensitive), generator=gen) > 0.5
    return ArrivalDraws(m=m, model=model, z_stay=z_stay, soc0=x / (x + y), z_tgt=z_tgt, bern=bern)


def _library_draws(params, state, gen, rate_extra=None) -> ArrivalDraws:
    """The same with the Poisson count drawn first, as the sampler draws it."""
    m = torch.poisson(sampling.arrival_rate(params, state, rate_extra), generator=gen).to(torch.int32)
    return _library_cars(params, state.day, state.occupied.shape[1], m, gen)


def _assert_equal(got: ArrivalDraws, want: ArrivalDraws) -> None:
    for name in ArrivalDraws.__dataclass_fields__:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


# ---------------------------------------------------------------------------
# CPU: the route, the launcher's view of the inputs, the work
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", ["paper_16", "fleet"])
def test_cpu_generator_gives_the_library_draws_bit_for_bit(world):
    env = _env() if world == "paper_16" else _fleet()
    params = env.default_params
    if world == "paper_16":
        _, state = env.reset(torch.Generator().manual_seed(3), params, num_envs=64)
    else:
        _, state = env.reset(torch.Generator().manual_seed(3), params)
    b, n = state.occupied.shape
    before = ops.arrivals.launches
    for rate_extra in (None, torch.linspace(0.0, 12.0, b)):
        got = sampling.draw_arrivals(params, state, torch.Generator().manual_seed(7), rate_extra)
        _assert_equal(got, _library_draws(params, state, torch.Generator().manual_seed(7), rate_extra))
    # given counts pass through as they are
    m = torch.arange(b, dtype=torch.int32)
    cars = sampling.draw_cars(params, state.day, n, m, torch.Generator().manual_seed(9))
    assert cars.m is m
    _assert_equal(cars, _library_cars(params, state.day, n, m, torch.Generator().manual_seed(9)))
    assert ops.arrivals.launches == before


def test_route_choice():
    on = lambda kind: types.SimpleNamespace(device=torch.device(kind))  # noqa: E731
    assert sampling.uses_kernel(torch.device("cuda", 0), on("cuda"))
    assert not sampling.uses_kernel(torch.device("cuda", 0), torch.Generator())
    assert not sampling.uses_kernel(torch.device("cpu"), on("cuda"))
    assert not sampling.uses_kernel(torch.device("cpu"), torch.Generator())


def test_prepare_reads_the_three_car_probs_layouts_through_their_strides():
    params = _env().default_params
    m = params.car_probs.shape[0]
    b, n = 6, 16
    day = torch.arange(b, dtype=torch.int32)
    t = torch.zeros(b, dtype=torch.int32)
    # (M,): one row for every env and day (paper_16's is itself a strided view)
    args = ops.prepare(params, day, n, t=t)
    p = args.probs
    assert (p.scen_stride, p.row_stride, p.col_stride, p.rows, p.cols) == (0, 0, params.car_probs.stride(0), 1, m)
    assert p.data == params.car_probs.data_ptr()
    assert args.scenario is None and args.scenario_stride == 0
    # (365, M) under drift: the row of day % 365
    drift = replace(params, car_probs=torch.rand(365, m))
    p = ops.prepare(drift, day, n, t=t).probs
    assert (p.scen_stride, p.row_stride, p.col_stride, p.rows, p.cols) == (0, m, 1, 365, m)
    # a fleet's (S, 365, M): a view with stride 0 over days where no scenario drifts
    fleet = _fleet()
    fp = fleet.default_params
    stacked = replace(fp, car_probs=torch.rand(3, m)[:, None, :].expand(3, 365, m))
    args = ops.prepare(stacked, fp.env_scenario.new_zeros(fleet.num_envs, dtype=torch.int32), n,
                       t=torch.zeros(fleet.num_envs, dtype=torch.int32))
    p = args.probs
    assert (p.scen_stride, p.row_stride, p.col_stride, p.rows, p.cols) == (m, 0, 1, 365, m)
    assert p.data == stacked.car_probs.data_ptr()  # no copy
    assert args.scenario == fp.env_scenario.data_ptr() and args.scenario_stride == 1
    assert args.inputs["scenario"].dtype == torch.int64
    # the kernel's reading is the plain version's row, env by env
    base = stacked.car_probs
    flat = base.as_strided((base.untyped_storage().nbytes() // 4 - base.storage_offset(),), (1,),
                           base.storage_offset())
    for bi in range(fleet.num_envs):
        d = int(bi * 37 % 365)
        s = int(fp.env_scenario[bi])
        row = flat[p.scen_stride * s + p.row_stride * (d % p.rows) + p.col_stride * torch.arange(m)]
        assert torch.equal(row, stacked.car_probs[s, d])
    # the clock tables: (rows,) alone, (S, rows) at each env's scenario
    r = ops.prepare(params, day, n, t=t).rate
    assert (r.scen_stride, r.row_stride, r.rows, r.cols) == (0, 1, params.arrival_rate.shape[0], 1)
    assert r.data == params.arrival_rate.data_ptr()
    r = args.rate
    assert (r.scen_stride, r.row_stride, r.rows) == (fp.arrival_rate.stride(0), 1, fp.arrival_rate.shape[-1])
    d = args.day_scale
    assert (d.scen_stride, d.row_stride, d.rows) == (fp.arrival_day_scale.stride(0), 1, 365)


def test_prepare_reads_per_port_fields_and_env_rows_through_their_strides():
    params = _env().default_params
    b, n = 5, 16
    day = torch.zeros(b, dtype=torch.int32)
    extra = torch.tensor(0.5)
    args = ops.prepare(params, day, n, t=torch.zeros(b, dtype=torch.int32), rate_extra=extra)
    for name in ("soc0_a", "soc0_b", "p_time_sensitive"):  # 0-d: one value for all
        f = getattr(args, name)
        assert (f.env_stride, f.port_stride) == (0, 0) and f.data == getattr(params, name).data_ptr()
        assert args.inputs[name].shape == (b, n)
    assert args.rate_extra == extra.data_ptr() and args.extra_stride == 0
    assert args.counts is None and args.counts_stride == 0
    assert (args.n_envs, args.n_ports, args.day, args.day_stride) == (b, n, day.data_ptr(), 1)
    rows = replace(params, soc0_a=torch.rand(b), p_time_sensitive=torch.rand(b))
    counts = torch.ones(b, dtype=torch.int32)
    args = ops.prepare(rows, day, n, counts=counts)
    assert (args.soc0_a.env_stride, args.soc0_a.port_stride) == (1, 0)
    assert args.soc0_a.data == rows.soc0_a.data_ptr()  # no copy
    assert args.t is None and args.rate.data is None and args.day_scale.data is None
    assert args.counts == counts.data_ptr() and args.counts_stride == 1


def test_prepare_refuses_what_the_kernel_does_not_take():
    params = _env().default_params
    day, t = torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32)
    counts = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="not both"):
        ops.prepare(params, day, 16, t=t, counts=counts)
    with pytest.raises(ValueError, match="not both"):
        ops.prepare(params, day, 16)
    with pytest.raises(ValueError, match="day has dtype"):
        ops.prepare(params, day.long(), 16, t=t)
    with pytest.raises(ValueError, match="counts has dtype"):
        ops.prepare(params, day, 16, counts=counts.float())
    with pytest.raises(ValueError, match="car_probs has shape"):
        ops.prepare(replace(params, car_probs=torch.rand(2, 365, 8)), day, 16, t=t)
    with pytest.raises(ValueError, match="soc0_a has dtype"):
        ops.prepare(replace(params, soc0_a=params.soc0_a.double()), day, 16, t=t)
    with pytest.raises(ValueError, match="at least one port"):
        ops.prepare(params, day, 0, t=t)


def test_work_counts_each_output_once_and_each_distinct_input_once():
    b, n = 262144, 16  # the eval cell's batch of paper_16's 16 ports
    w = ops.work(b, n)
    assert w.name == "arrivals" and w.ops == 0.0
    # the count, then an int64 model, three float32 draws and a bool per port
    assert w.bytes == 4 * b + (8 + 4 + 4 + 4 + 1) * b * n == 89_128_960
    params = _env().default_params
    day, t = torch.zeros(b, dtype=torch.int32), torch.zeros(b, dtype=torch.int32)
    args = ops.prepare(params, day, n, t=t)
    tables = params.arrival_rate.numel() + params.arrival_day_scale.numel() + params.car_probs.numel()
    assert ops.input_bytes(args) == 4 * b + 4 * b + 4 * tables + 3 * 4
    fleet = _fleet()
    fp = fleet.default_params
    bf = fleet.num_envs
    args = ops.prepare(fp, fp.env_scenario.new_zeros(bf, dtype=torch.int32), 16,
                       t=torch.zeros(bf, dtype=torch.int32), rate_extra=torch.zeros(bf))
    tables = fp.arrival_rate.numel() + fp.arrival_day_scale.numel() + fp.car_probs.numel()
    assert ops.input_bytes(args) == (4 + 4 + 4 + 8) * bf + 4 * tables + 3 * 4 * bf


# ---------------------------------------------------------------------------
# The card: the kernel's draws against their distributions
# ---------------------------------------------------------------------------
def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the arrivals kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _card_draws(b: int = B_CARD, params=None, rate_extra=None, seed: int = 0):
    dev = _card()
    env = _env(dev)
    params = env.default_params if params is None else params
    state = _state(env, params, b)
    gen = torch.Generator(device=dev).manual_seed(seed)
    before = ops.arrivals.launches
    d = sampling.draw_arrivals(params, state, gen, rate_extra)
    torch.cuda.synchronize()
    assert ops.arrivals.launches == before + 1
    return params, state, d


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.3, 2.5, 9.5, 10.0, 37.0, 150.0])
def test_cuda_poisson_mean_and_variance(rate):
    dev = _card()
    env = _env(dev)
    state = _state(env, env.default_params, B_CARD)
    extra = rate - sampling.arrival_rate(env.default_params, state)  # rate_extra sets the rate
    _, _, d = _card_draws(rate_extra=extra)
    m = d.m.double()
    assert abs(m.mean().item() - rate) < 4 * math.sqrt(rate / B_CARD)
    assert abs(m.var().item() - rate) < 0.05 * rate
    assert int(d.m.min()) >= 0


@pytest.mark.cuda
def test_cuda_draws_keep_their_dtypes_and_shapes():
    params, state, d = _card_draws(b=300)
    n = state.occupied.shape[1]
    want = {"m": (torch.int32, (300,)), "model": (torch.int64, (300, n)), "z_stay": (torch.float32, (300, n)),
            "soc0": (torch.float32, (300, n)), "z_tgt": (torch.float32, (300, n)), "bern": (torch.bool, (300, n))}
    for name, (dtype, shape) in want.items():
        x = getattr(d, name)
        assert x.dtype == dtype and tuple(x.shape) == shape and x.is_contiguous() and x.device.type == "cuda", name


@pytest.mark.cuda
def test_cuda_beta_bernoulli_and_normal_moments():
    params, _, d = _card_draws()
    a, b = float(params.soc0_a), float(params.soc0_b)
    soc0 = d.soc0.double()
    assert bool(((soc0 > 0) & (soc0 < 1)).all())
    assert abs(soc0.mean().item() - a / (a + b)) < 2e-3
    var = a * b / ((a + b) ** 2 * (a + b + 1))
    assert abs(soc0.var().item() - var) < 0.03 * var
    assert abs(d.bern.double().mean().item() - float(params.p_time_sensitive)) < 3e-3
    for z in (d.z_stay, d.z_tgt):
        assert abs(z.double().mean().item()) < 0.01
        assert abs(z.double().std().item() - 1.0) < 0.01
    assert abs((d.z_stay.double() * d.z_tgt.double()).mean().item()) < 0.01  # independent
    assert bool(torch.isfinite(d.z_stay).all() & torch.isfinite(d.z_tgt).all())


@pytest.mark.cuda
def test_cuda_car_models_follow_each_scenarios_row():
    dev = _card()
    fleet = _fleet(dev, replicas=B_CARD // 3)
    m = fleet.default_params.car_probs.shape[-1]
    rows = torch.tensor([[0.0, 1.0] + [0.0] * (m - 2), [0.25] * 4 + [0.0] * (m - 4), [0.0] * (m - 1) + [3.0]])
    params = replace(fleet.default_params, car_probs=rows.to(dev)[:, None, :].expand(3, 365, m))
    state = _state(fleet, params, fleet.num_envs)
    d = sampling.draw_arrivals(params, state, torch.Generator(device=dev).manual_seed(4))
    scen = params.env_scenario
    for s in range(3):
        models = d.model[scen == s].flatten()
        freq = torch.bincount(models, minlength=m).double().cpu() / models.numel()
        want = rows[s].double() / rows[s].sum()
        np.testing.assert_allclose(freq.numpy(), want.numpy(), atol=4e-3)
        assert bool((want[freq > 0] > 0).all())  # never a model of probability 0


@pytest.mark.cuda
def test_cuda_seeded_generator_repeats_and_advances():
    dev = _card()
    env = _env(dev)
    params = env.default_params
    state = _state(env, params, 4096)
    g1 = torch.Generator(device=dev).manual_seed(2**40 + 11)
    g2 = torch.Generator(device=dev).manual_seed(2**40 + 11)
    first = sampling.draw_arrivals(params, state, g1)
    assert g1.get_offset() == ops.VALUES_PER_THREAD
    again = sampling.draw_arrivals(params, state, g2)
    _assert_equal(first, again)
    second = sampling.draw_arrivals(params, state, g1)
    assert g1.get_offset() == 2 * ops.VALUES_PER_THREAD
    assert not torch.equal(first.z_stay, second.z_stay) and not torch.equal(first.soc0, second.soc0)
    # given counts are copied, the per-port draws made as with a drawn count
    counts = torch.arange(4096, dtype=torch.int32, device=dev)
    g3 = torch.Generator(device=dev).manual_seed(2**40 + 11)
    cars = sampling.draw_cars(params, state.day, state.occupied.shape[1], counts, g3)
    assert torch.equal(cars.m, counts) and cars.m.data_ptr() != counts.data_ptr()
    assert torch.equal(cars.model, first.model) and torch.equal(cars.soc0, first.soc0)


def _one_hot(index: Tensor, m: int) -> Tensor:
    return torch.nn.functional.one_hot(index, m).float()


@pytest.mark.cuda
def test_cuda_car_models_follow_each_days_row():
    """A (365, M) table that differs by day (under drift): each env draws
    from the row of its own day."""
    dev = _card()
    env = _env(dev)
    m = env.default_params.car_probs.shape[0]
    days = torch.arange(365)
    # one model a day: every draw of an env is its day's model
    table = _one_hot((3 * days + 1) % m, m)
    params = replace(env.default_params, car_probs=table.to(dev))
    env_day = torch.arange(B_CARD) % 365
    state = _state(env, params, B_CARD, day=env_day)
    d = sampling.draw_arrivals(params, state, torch.Generator(device=dev).manual_seed(5))
    want = ((3 * env_day + 1) % m).to(dev)
    assert bool((d.model == want[:, None]).all())
    # weights that differ by day (not normalised): half the envs on day 10, half on day 200
    weights = 1.0 + (days[:, None] * 7 + torch.arange(m)[None, :] * 3) % 11
    params = replace(env.default_params, car_probs=weights.float().to(dev))
    env_day = torch.where(torch.arange(B_CARD) % 2 == 0, 10, 200)
    state = _state(env, params, B_CARD, day=env_day)
    d = sampling.draw_arrivals(params, state, torch.Generator(device=dev).manual_seed(6))
    for day in (10, 200):
        models = d.model[(env_day == day).to(dev)].flatten()
        freq = torch.bincount(models, minlength=m).double().cpu() / models.numel()
        want = weights[day].double() / weights[day].sum()
        np.testing.assert_allclose(freq.numpy(), want.numpy(), atol=4e-3)


@pytest.mark.cuda
def test_cuda_car_models_follow_each_scenarios_row_of_each_day():
    """A fleet's (S, 365, M) stack that differs by scenario and by day: each
    env draws from its scenario's row of its own day."""
    dev = _card()
    fleet = _fleet(dev, replicas=B_CARD // 3)
    m = fleet.default_params.car_probs.shape[-1]
    b = fleet.num_envs
    scen_ids, days = torch.arange(3)[:, None], torch.arange(365)[None, :]
    table = _one_hot((scen_ids + 2 * days) % m, m)  # (3, 365, M)
    params = replace(fleet.default_params, car_probs=table.to(dev))
    env_day = torch.arange(b) * 7 % 365
    state = _state(fleet, params, b, day=env_day)
    d = sampling.draw_arrivals(params, state, torch.Generator(device=dev).manual_seed(7))
    want = (params.env_scenario.cpu() + 2 * env_day) % m
    assert bool((d.model.cpu() == want[:, None]).all())
    # weights that differ by scenario and day: envs on day 10 or day 200
    weights = (1.0 + (scen_ids[..., None] * 5 + days[..., None] * 7 + torch.arange(m) * 3) % 11).float()
    params = replace(fleet.default_params, car_probs=weights.to(dev))
    env_day = torch.where(torch.arange(b) % 2 == 0, 10, 200)
    state = _state(fleet, params, b, day=env_day)
    d = sampling.draw_arrivals(params, state, torch.Generator(device=dev).manual_seed(8))
    scen = params.env_scenario.cpu()
    for s_ in range(3):
        for day in (10, 200):
            models = d.model.cpu()[(scen == s_) & (env_day == day)].flatten()
            freq = torch.bincount(models, minlength=m).double() / models.numel()
            want = weights[s_, day].double() / weights[s_, day].sum()
            np.testing.assert_allclose(freq.numpy(), want.numpy(), atol=4e-3)
