"""The port's city package and the city-coupled fleet against the JAX package.

Mirrors ``tests/city/test_demand.py`` (all but the two-device sharded case,
which waits for env sharding) and ``tests/city/test_fleet_city.py``.  The
numpy builders (``layout_xy``, ``demand_zones``) and ``make_city`` give
identical arrays; the choice model (softmax, norms, clamps) agrees within
rtol 1e-6 / atol 1e-6.  City-coupled fleet rollouts run on JAX's reset days,
actions and per-station arrival draws (the Poisson count at JAX's own rate,
``city/arrival_rate`` included) at the tolerances of
``tests/test_torch_fleet.py`` (observation ``TIGHT``, the rest ``EQ5``,
discrete state exact); the per-station rates also within ``EQ5``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import city as jcity
from repro import scenarios as jscenarios
from repro.core import EnvConfig as JaxConfig
from repro.core import FleetEnv as JaxFleet
from repro.rl.baselines import max_charge_policy as jax_max_charge
from repro.utils import stack_pytrees
from repro_torch import city, convert
from repro_torch.city import (
    CityParams,
    StationFeatures,
    allocate_demand,
    choice_logits,
    demand_zones,
    layout_xy,
    make_city,
    stream_rate,
)
from repro_torch.core import EnvConfig, FleetEnv
from repro_torch.core.sampling import ResetDraws
from repro_torch.rl import max_charge_policy
from test_torch_fleet import (
    INFO_KEYS,
    assert_fleet_step,
    jax_fleet_rollout,
    port_draws,
    port_fleet_rollout,
)
from test_torch_transition import EQ5, replay_arrive_draws

ARCHS = ["paper_16", "deep_4x4", "single_dc_8"]
ROLLOUT_ARCHS = ["paper_16", "deep_4x4", "single_dc_8", "paper_16"]  # examples/city_rollout.py
NEAR = dict(rtol=1e-6, atol=1e-6)
CITY_INFO = INFO_KEYS + ("city/arrival_rate", "city/overflow", "city/stream")


def _city(population=2000.0, n_stations=4, **kw):
    return make_city(n_stations=n_stations, population=population, device="cpu", **kw)


def _features(n_stations=4, free=6.0):
    return StationFeatures(
        price=torch.linspace(0.2, 0.5, n_stations),
        occupancy=torch.linspace(0.0, 0.9, n_stations),
        free_ports=torch.full((n_stations,), float(free)),
    )


def _jax_city(c: CityParams):
    return jcity.CityParams(**{f.name: jnp.asarray(getattr(c, f.name).numpy()) for f in dataclasses.fields(c)})


def _jax_features(f: StationFeatures):
    return jcity.StationFeatures(*(jnp.asarray(x.numpy()) for x in f))


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------
def test_layout_and_zone_builders_equal_jaxs():
    for kind in ("ring", "grid", "clustered"):
        for n in (1, 3, 4, 5, 6, 9):
            for radius, seed in ((5.0, 11), (3.0, 2)):
                np.testing.assert_array_equal(
                    layout_xy(kind, n, radius, seed), jcity.layout_xy(kind, n, radius, seed)
                )
    for z in (1, 3, 4, 7):
        for got, want in zip(demand_zones(z, 4.0, 5), jcity.demand_zones(z, 4.0, 5)):
            np.testing.assert_array_equal(got, want)
    assert layout_xy("grid", 5).shape == (5, 2) and layout_xy("clustered", 3).shape == (3, 2)
    xy, frac = demand_zones(4)
    assert xy.shape == (4, 2) and frac.shape == (4,)
    np.testing.assert_allclose(frac.sum(), 1.0, rtol=1e-6)
    with pytest.raises(ValueError):
        layout_xy("hexagonal", 4)
    with pytest.raises(ValueError):
        layout_xy("ring", 0)
    with pytest.raises(ValueError):
        demand_zones(0)


@pytest.mark.parametrize(
    "name", (None,) + tuple(jscenarios.CITY_PACK), ids=lambda n: n or "defaults"
)
def test_make_city_equals_jaxs(name):
    """Every CITY_PACK scenario's city axis (and the defaults), with and
    without overrides and an explicit layout, field for field exactly."""
    xy = np.random.default_rng(0).uniform(-5, 5, (6, 2)).astype(np.float32)
    for kw in ({}, dict(population=7.0, n_zones=5, w_price=1.5), dict(layout=xy)):
        got = make_city(name, n_stations=6, device="cpu", **kw)
        want = jcity.make_city(name, n_stations=6, **kw)
        for f in dataclasses.fields(got):
            np.testing.assert_array_equal(
                getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)), err_msg=f.name
            )
    carried = convert.city_from_numpy(
        {f.name: np.asarray(getattr(want, f.name)) for f in dataclasses.fields(got)}, device="cpu"
    )
    assert all(torch.equal(getattr(carried, f.name), getattr(got, f.name)) for f in dataclasses.fields(got))


def test_make_city_from_scenario_and_overrides():
    c = make_city("city_grid_commuters", n_stations=6, device="cpu")
    assert isinstance(c, CityParams) and c.n_stations == 6
    assert float(c.population) == 2400.0
    np.testing.assert_allclose(float(c.arrival_profile.sum()), 1.0, rtol=1e-5)
    assert float(make_city("city_grid_commuters", n_stations=6, population=7.0, device="cpu").population) == 7.0
    with pytest.raises(ValueError):
        make_city(layout=np.zeros((3, 2)), n_stations=4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_city(n_stations=4)  # the card unless the caller names another


# ---------------------------------------------------------------------------
# Demand allocation (tests/city/test_demand.py)
# ---------------------------------------------------------------------------
def test_conservation_and_nonnegativity_and_jax():
    c = _city()
    jc = _jax_city(c)
    for t in (0, 90, 200):
        stream = stream_rate(c, torch.tensor(3), torch.tensor(t))
        alloc = allocate_demand(stream, c, _features())
        total = float(alloc.rates.sum() + alloc.overflow)
        np.testing.assert_allclose(total, float(stream), rtol=1e-5)
        assert (alloc.rates >= 0.0).all() and float(alloc.overflow) >= 0.0
        np.testing.assert_allclose(float(alloc.shares.sum()), 1.0, rtol=1e-5)
        jstream = jcity.stream_rate(jc, jnp.int32(3), jnp.int32(t))
        want = jcity.allocate_demand(jstream, jc, _jax_features(_features()))
        np.testing.assert_allclose(float(stream), float(jstream), **NEAR)
        for g, w in zip(alloc, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **NEAR)


def test_capacity_clamp_and_overflow():
    """A station absorbs at most its free ports; an over-capacity stream
    produces city-wide overflow, never over-assignment."""
    alloc = allocate_demand(torch.tensor(100.0), _city(population=50_000.0), _features(free=2.0))
    assert (alloc.rates <= 2.0 + 1e-5).all()
    np.testing.assert_allclose(float(alloc.rates.sum()), 8.0, rtol=1e-5)
    np.testing.assert_allclose(float(alloc.overflow), 92.0, rtol=1e-5)


def test_zero_population_yields_exact_zero_rates():
    c = _city(population=0.0)
    stream = stream_rate(c, torch.tensor(0), torch.tensor(100))
    assert float(stream) == 0.0
    alloc = allocate_demand(stream, c, _features())
    assert (alloc.rates == 0.0).all() and float(alloc.overflow) == 0.0


def test_allocation_of_a_stack_equals_one_city_at_a_time():
    """A stack of cities (the sweep's access pattern) splits each stream as
    the city alone does, bit for bit, and as JAX's vmap does within NEAR."""
    cities = [_city(population=p) for p in (800.0, 2000.0, 5000.0)]
    feats = _features()
    stream = torch.tensor(40.0)
    stacked = allocate_demand(
        stream.expand(3), CityParams.stack(cities), StationFeatures(*(x.expand(3, -1) for x in feats))
    )
    jstacked = jax.vmap(lambda c: jcity.allocate_demand(jnp.float32(40.0), c, _jax_features(feats)))(
        stack_pytrees([_jax_city(c) for c in cities])
    )
    for i, c in enumerate(cities):
        solo = allocate_demand(stream, c, feats)
        assert torch.equal(stacked.rates[i], solo.rates) and torch.equal(stacked.overflow[i], solo.overflow)
        np.testing.assert_allclose(stacked.rates[i].numpy(), np.asarray(jstacked.rates[i]), **NEAR)


def test_price_and_queue_shift_shares():
    c = _city(w_dist=0.0)
    base = StationFeatures(price=torch.full((4,), 0.3), occupancy=torch.zeros(4), free_ports=torch.full((4,), 100.0))
    ref = allocate_demand(torch.tensor(10.0), c, base)
    price = base.price.clone()
    price[0] += 0.2
    occ = base.occupancy.clone()
    occ[0] = 0.8
    pricey = allocate_demand(torch.tensor(10.0), c, base._replace(price=price))
    busy = allocate_demand(torch.tensor(10.0), c, base._replace(occupancy=occ))
    assert float(pricey.shares[0]) < float(ref.shares[0])
    assert float(busy.shares[0]) < float(ref.shares[0])


def test_choice_logits_shape_and_distance_decay():
    c = _city(w_price=0.0, w_queue=0.0)
    lg = choice_logits(c, _features())
    assert lg.shape == (c.n_zones, c.n_stations)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jcity.choice_logits(_jax_city(c), _jax_features(_features()))), **NEAR)
    d = torch.linalg.vector_norm(c.station_xy - c.zone_xy[0], dim=-1)
    assert np.argsort(lg[0].numpy()).tolist() == np.argsort(-d.numpy()).tolist()


def test_station_features_and_city_rates_match_jax():
    """On a mid-episode fleet state: the features per station, and the rates
    of 2 fleets reading their own station 0's clock, against JAX's per
    fleet."""
    archs = ("paper_16", "deep_4x4")
    jfleet = JaxFleet(list(archs))
    c = make_city("city_ring_evening", n_stations=2, device="cpu")
    days, steps = jax_fleet_rollout(jfleet, 2, 30, seed=4)
    fleet = FleetEnv(list(archs), replicas=2, device="cpu")
    state = port_fleet_rollout(fleet, days, steps)
    state_j = steps[-1][1][1]
    params_j = jfleet.default_params
    feats = city.station_features(fleet.default_params, state)
    calloc, stream = city.city_rates(c, fleet.default_params, state)
    assert calloc.rates.shape == (2, 2) and stream.shape == (2,)
    for e in range(2):
        st_e = jax.tree_util.tree_map(lambda x: x[e], state_j)
        want_f = jcity.station_features(params_j, st_e)
        for g, w in zip(feats, want_f):
            np.testing.assert_allclose(g.reshape(2, 2)[e].numpy(), np.asarray(w), **NEAR)
        want, want_stream = jcity.city_rates(_jax_city(c), params_j, st_e)
        np.testing.assert_allclose(float(stream[e]), float(want_stream), **NEAR)
        np.testing.assert_allclose(calloc.rates[e].numpy(), np.asarray(want.rates), **NEAR)


# ---------------------------------------------------------------------------
# The city-coupled fleet (tests/city/test_fleet_city.py)
# ---------------------------------------------------------------------------
def _generator_rollout(fleet, n_steps=50):
    params = fleet.default_params
    gen = torch.Generator().manual_seed(0)
    _, state = fleet.reset(gen, params)
    obs_t, rew_t, info = [], [], None
    for _ in range(n_steps):
        obs, state, r, _, info = fleet.step(gen, state, fleet.sample_action(gen), params)
        obs_t.append(obs)
        rew_t.append(r)
    return torch.stack(obs_t), torch.stack(rew_t), state, info


def test_zero_population_city_is_exactly_the_uncoupled_fleet():
    """A city of population 0 adds exactly 0.0 to every station's Poisson
    rate: the coupled fleet, generator-driven, is the uncoupled staged fleet
    bit for bit."""
    city0 = make_city(n_stations=len(ARCHS), population=0.0, device="cpu")
    ref_obs, ref_rew, ref_state, _ = _generator_rollout(FleetEnv(ARCHS, replicas=2, device="cpu"))
    got_obs, got_rew, got_state, info = _generator_rollout(FleetEnv(ARCHS, city=city0, replicas=2, device="cpu"))
    assert torch.equal(got_obs, ref_obs) and torch.equal(got_rew, ref_rew)
    for f in dataclasses.fields(ref_state):
        assert torch.equal(getattr(got_state, f.name), getattr(ref_state, f.name)), f.name
    assert (info["city/arrival_rate"] == 0.0).all()  # the seam is live, just inert


def test_coupled_fleet_receives_city_arrivals_as_jax():
    """A real population injects demand: 2 fleets over 50 steps on JAX's
    draws at JAX's rates, every station against JAX's city-coupled fleet;
    the rates conserve each fleet's stream, and the fleet serves more cars
    than uncoupled."""
    jc = jcity.make_city("city_ring_evening", n_stations=len(ARCHS), population=5000.0)
    c = make_city("city_ring_evening", n_stations=len(ARCHS), population=5000.0, device="cpu")
    days, steps = jax_fleet_rollout(JaxFleet(ARCHS, city=jc), 2, 50, seed=0)
    fleet = FleetEnv(ARCHS, city=c, replicas=2, device="cpu")
    infos = []

    def check(t, ts, ts_j):
        assert_fleet_step(f"city step {t}", ts, ts_j, CITY_INFO)
        infos.append(ts[4])

    state = port_fleet_rollout(fleet, days, steps, check=check)
    info = infos[-1]
    rates = info["city/arrival_rate"].reshape(2, 3)
    assert (rates >= 0).all()
    total = rates.sum(1) + info["city/overflow"].reshape(2, 3)[:, 0]
    np.testing.assert_allclose(total.numpy(), info["city/stream"].reshape(2, 3)[:, 0].numpy(), rtol=1e-4)
    _, _, ref_state, _ = _generator_rollout(FleetEnv(ARCHS, replicas=2, device="cpu"))
    assert state.cars_served.sum() > ref_state.cars_served.sum()


def test_fleet_builds_city_from_scenario_name():
    fleet = FleetEnv(ARCHS, EnvConfig(), city="city_clustered_core", device="cpu")
    assert fleet.city is not None and fleet.city.n_stations == len(ARCHS)
    assert float(fleet.city.population) == 3200.0


def test_fleet_rejects_station_count_mismatch():
    with pytest.raises(ValueError, match="city has 5 stations, fleet has 3"):
        FleetEnv(ARCHS, EnvConfig(), city=make_city(n_stations=5, device="cpu"), device="cpu")


def test_city_swap_is_a_pure_tensor_swap():
    """Passing a city to ``step_with_city`` is the fleet built with that
    city: the same step, the same numbers, for each of three cities."""
    fleet = FleetEnv(ARCHS, replicas=2, device="cpu")
    params = fleet.default_params
    gen = torch.Generator().manual_seed(0)
    _, state = fleet.reset(gen, params)
    a = fleet.sample_action(gen)
    for name in ("city_ring_evening", "city_grid_commuters", "city_price_shoppers"):
        c = make_city(name, n_stations=len(ARCHS), device="cpu")
        got = fleet.step_with_city(torch.Generator().manual_seed(2), state, a, params, c)
        built = FleetEnv(ARCHS, city=c, replicas=2, device="cpu")
        want = built.step(torch.Generator().manual_seed(2), state, a, params)
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]), name
        assert torch.equal(got[4]["city/arrival_rate"], want[4]["city/arrival_rate"]), name


def _jax_sweep_draws(jfleet, jcities, steps, key, action):
    """The draws JAX's ``sweep_layouts`` makes: every candidate on the same
    key (reset, then split(key, 3) per step), each at its own city rates."""
    params = jfleet.default_params
    s = jfleet.n_stations
    k = jcities.station_xy.shape[0]
    action = jnp.broadcast_to(action, (s,) + action.shape)

    @jax.jit
    def step(k_step, state, cities):
        out = jax.vmap(lambda st, c: jfleet.step_with_city(k_step, st, action, params, c))(state, cities)
        keys = jax.random.split(k_step, s)
        k_arr = jax.vmap(lambda kk: jax.random.split(kk)[1])(keys)
        replay = jax.vmap(jax.vmap(replay_arrive_draws), in_axes=(None, 0, None, 0))
        return out, replay(params, state, k_arr, out[4]["city/arrival_rate"])

    keys = jax.random.split(key, s)
    days = jax.vmap(lambda kk: jax.random.randint(jax.random.split(kk)[0], (), 0, 365))(keys)
    _, state = jfleet.reset(key, params)
    state = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (k,) + x.shape), state)
    draws = []
    for _ in range(steps):
        key, _, k_step = jax.random.split(key, 3)
        out, d = step(k_step, state, jcities)
        draws.append(port_draws(jax.tree_util.tree_map(np.asarray, d)))
        state = out[1]
    return np.tile(np.asarray(days), k), draws


def test_sweep_layouts_scores_candidates_as_jax():
    """Two candidate layouts of the 4-station city_rollout fleet, 24 steps
    under max-charge actions, on JAX's draws: profit, cars served and
    overflow per candidate against JAX's ``sweep_layouts``."""
    name, n = "city_ring_evening", len(ROLLOUT_ARCHS)
    jfleet = JaxFleet(ROLLOUT_ARCHS, JaxConfig(), city=name)
    kinds = ("ring", "clustered")
    jcities = [jcity.make_city(name, n_stations=n, layout=kind) for kind in kinds]
    key = jax.random.key(3)
    want = jcity.sweep_layouts(jfleet, jcities, jax_max_charge(jfleet.template), steps=24, key=key)
    fleet = FleetEnv(ROLLOUT_ARCHS, city=name, device="cpu")
    cities = [make_city(name, n_stations=n, layout=kind, device="cpu") for kind in kinds]
    action = max_charge_policy(fleet.template)(None, None, torch.zeros(1, 1))[0]
    days, draws = _jax_sweep_draws(jfleet, stack_pytrees(jcities), 24, key, jnp.asarray(action.numpy()))
    got = city.sweep_layouts(
        fleet, cities, max_charge_policy(fleet.template), steps=24,
        draws=(ResetDraws(day=torch.from_numpy(days.astype(np.int32))), draws),
    )
    for k in ("profit", "cars_served", "overflow"):
        assert got[k].shape == (2,)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **EQ5, err_msg=k)
    assert int(got["best"]) == int(want["best"]) == int(torch.argmax(got["profit"]))
    # from a generator the candidates score too, one episode each
    out = city.sweep_layouts(fleet, cities, max_charge_policy(fleet.template), steps=24)
    assert out["profit"].shape == (2,) and torch.isfinite(out["profit"]).all()


def test_sweep_layouts_shares_draws_across_candidates():
    """From a generator the candidates run on common random numbers: a
    layout scores the same alone as beside others, and two copies of one
    layout score the same, so the scores differ through the layouts."""
    name, n = "city_ring_evening", len(ROLLOUT_ARCHS)
    fleet = FleetEnv(ROLLOUT_ARCHS, city=name, device="cpu")
    ring, clustered = (make_city(name, n_stations=n, layout=kind, device="cpu") for kind in ("ring", "clustered"))
    policy = max_charge_policy(fleet.template)
    alone = city.sweep_layouts(fleet, [ring], policy, rng=torch.Generator().manual_seed(5), steps=48)
    both = city.sweep_layouts(fleet, [ring, clustered, ring], policy, rng=torch.Generator().manual_seed(5), steps=48)
    for k in ("profit", "cars_served", "overflow"):
        assert torch.equal(both[k][0], both[k][2]), k
        torch.testing.assert_close(both[k][:1], alone[k], rtol=0, atol=0, msg=k)
    assert both["cars_served"][0] > 0
    assert not torch.equal(both["overflow"][0], both["overflow"][1])  # the layouts do differ


@pytest.mark.parametrize("rate", [0.0, 0.05, 1.3, 9.0, 60.0])
def test_poisson_quantile_draws_poisson_counts(rate):
    """The sweep's Poisson quantile of a uniform: mean and variance within
    5 standard errors of the rate on 200,000 draws, a zero rate gives no
    car, and at one uniform the count never falls as the rate grows."""
    from repro_torch.core.sampling import poisson_quantile

    n = 200_000
    u = torch.rand(n, generator=torch.Generator().manual_seed(7))
    m = poisson_quantile(u, torch.full((n,), rate)).double()
    if rate == 0.0:
        assert (m == 0).all()
        return
    assert abs(float(m.mean()) - rate) < 5 * (rate / n) ** 0.5
    # var of the sample variance of a Poisson: (rate + 2 rate^2 (n/(n-1))) / n
    assert abs(float(m.var()) - rate) < 5 * ((rate + 2 * rate**2) / n) ** 0.5
    higher = poisson_quantile(u, torch.full((n,), rate * 1.1)).double()
    assert (higher >= m).all()
