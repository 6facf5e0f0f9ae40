"""The port's env sharding over a torch process group, against the
unsharded port.

Mirrors ``tests/distributed/test_env_sharding.py``: the placement rule
(``env_shardings``: a leaf shards where its leading dim divides the group,
else it is replicated), scenario tables kept one copy per scenario, and the
errors.  JAX shards by a constraint and its values never change, so its
sharded run is its unsharded one; the port's sharded run is held to the
single-process port instead, on the same :class:`ReplayDraws`.

The groups are gloo groups of spawned processes on the CPU
(``torch.multiprocessing.spawn``), rendezvousing through a file in the
test's temporary directory (never a port, so parallel test workers never
meet), each joined with a timeout.  Tolerances: a sharded update sums the
loss, GAE's statistics and the gradients in another order, so parameters
and metrics agree within ``SHARD_TOL`` (rtol 1e-4 / atol 1e-6), above the
differences seen (at most 8.3e-7 in a parameter, 2.4e-7 relative in a
metric) and far below an update's step (lr 2.5e-4 a step); a sharded
fleet steps the same rows through the same ops, so its rewards and
observations are equal to the unsharded fleet's block exactly.
"""
from __future__ import annotations

import dataclasses
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import scenarios
from repro_torch.core import ChargaxEnv, EnvConfig, FleetEnv, sampling
from repro_torch.core.sampling import ResetDraws
from repro_torch.distributed import EnvShard, env_shardings, make_shard_envs, place_env_batch
from repro_torch.launch.rl_train import env_shard_for
from repro_torch.rl import PPOConfig, make_train, networks
from repro_torch.rl.networks import ActorCritic
from repro_torch.rl.ppo import ReplayDraws, StepDraws
from repro_torch.utils import replace

SHARD_TOL = dict(rtol=1e-4, atol=1e-6)
JOIN_TIMEOUT_S = 120
# a 1-hour episode (12 steps), so each update's 16 steps cross an episode end
ENV_CONFIG = EnvConfig(episode_hours=1.0, fused_step=True)
PPO = dict(num_envs=8, rollout_steps=16, num_minibatches=2, update_epochs=2, hidden=(16,))
UPDATES = 2
FLEET_ARCHS = ("paper_16", "deep_4x4", "single_dc_8")
FLEET_REPLICAS, FLEET_STEPS = 4, 12
SCEN_NAMES = ["shopping_flat", "shopping_pv_tou", "highway_demand_charge"]


def _ppo_config(num_envs: int = PPO["num_envs"]) -> PPOConfig:
    cfg = dict(PPO, num_envs=num_envs)
    return PPOConfig(total_timesteps=num_envs * cfg["rollout_steps"] * UPDATES, **cfg)


def _replay(env: ChargaxEnv, cfg: PPOConfig, seed: int) -> ReplayDraws:
    """Every draw of a ``make_train`` run, made up front (all envs start at
    t = 0 and restart together at the fixed horizon)."""
    gen = torch.Generator().manual_seed(seed)
    params, b, ep = env.default_params, cfg.num_envs, env.config.episode_steps
    first = sampling.draw_reset(params, b, gen)
    _, state = env.reset(first)
    day, steps = first.day, []
    for s in range(cfg.num_updates * cfg.rollout_steps):
        t = torch.full((b,), s % ep, dtype=torch.int32)
        gumbel = networks.gumbel_noise((b, env.num_action_heads, env.num_actions_per_head), gen, env.device)
        arrivals = sampling.draw_arrivals(params, replace(state, t=t, day=day), gen)
        reset = sampling.draw_reset(params, b, gen)
        steps.append(StepDraws(gumbel, arrivals, reset))
        if s % ep == ep - 1:
            day = reset.day
    perms = [torch.randperm(cfg.batch_size, generator=gen) for _ in range(cfg.num_updates * cfg.update_epochs)]
    return ReplayDraws(first, steps, perms)


def _net(env: ChargaxEnv, cfg: PPOConfig) -> ActorCritic:
    return ActorCritic(env.obs_dim, env.num_action_heads, env.num_actions_per_head, cfg.hidden, seed=3)


def _train(shard: EnvShard | None) -> dict:
    env = ChargaxEnv(ENV_CONFIG, device="cpu")
    cfg = _ppo_config()
    out = make_train(cfg, env, device="cpu", shard_envs=shard)(_replay(env, cfg, 11), _net(env, cfg))
    params = {k: v.detach().clone() for k, v in out["runner_state"].params.named_parameters()}
    return {"params": params, "metrics": out["metrics"]}


def _fleet_rollout(fleet: FleetEnv, draws: tuple, shard: EnvShard | None) -> dict:
    """``FLEET_STEPS`` steps of ``fleet`` on the global ``draws`` (cut to
    this rank's block where the fleet is sharded)."""
    reset, steps, actions = draws if shard is None else place_env_batch(draws, shard)
    obs, state = fleet.reset(reset)
    rewards, observations, fleet_rewards = [], [obs], []
    for arrivals, action in zip(steps, actions):
        obs, state, reward, _, info = fleet.step(arrivals, state, action)
        rewards.append(reward)
        observations.append(obs)
        fleet_rewards.append(info["fleet_reward"])
    return {k: torch.stack(v) for k, v in
            (("reward", rewards), ("obs", observations), ("fleet_reward", fleet_rewards))}


def _fleet_draws(fleet: FleetEnv) -> tuple:
    """Global reset, arrival and action draws for the whole (unsharded) fleet."""
    gen = torch.Generator().manual_seed(5)
    params = fleet.default_params
    reset = sampling.draw_reset(params, fleet.num_envs, gen)
    _, state = fleet.reset(reset)
    steps, actions = [], []
    for _ in range(FLEET_STEPS):
        steps.append(sampling.draw_arrivals(params, state, gen))
        actions.append(fleet.sample_action(gen))
        state = fleet.step(steps[-1], state, actions[-1])[1]
    return ResetDraws(reset.day), steps, actions


def _worker(rank: int, world: int, init_method: str, out_dir: str) -> None:
    """One rank: the sharded PPO run, the sharded fleet rollouts, the
    scenario tables and one generator-driven update, saved for the test."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    try:
        shard = make_shard_envs(device="cpu")
        out = {"ppo": _train(shard), "block": shard.block(PPO["num_envs"])}

        full = FleetEnv(FLEET_ARCHS, ENV_CONFIG, replicas=FLEET_REPLICAS, shard=False, device="cpu")
        sharded = FleetEnv(FLEET_ARCHS, ENV_CONFIG, replicas=FLEET_REPLICAS, device="cpu")
        draws = _fleet_draws(full)
        out["fleet"] = {
            "full": _fleet_rollout(full, draws, None),
            "sharded": _fleet_rollout(sharded, draws, sharded.env_shard),
            "local_replicas": sharded.local_replicas,
        }
        odd = FleetEnv(FLEET_ARCHS, ENV_CONFIG, replicas=world + 1, device="cpu")
        out["odd_fleet"] = (odd.env_shard is None, odd.num_envs)

        env = ChargaxEnv(ENV_CONFIG, device="cpu")
        stacked = scenarios.stack_params([scenarios.make(n).make_params(env) for n in SCEN_NAMES])
        cfg = _ppo_config(num_envs=6)
        train = make_train(cfg, env, device="cpu", scenario_params=stacked, shard_envs=shard)
        lowered = train.lowered_env_params
        metrics = train(torch.Generator().manual_seed(0))["metrics"]
        out["scenarios"] = {
            "tables": {f: tuple(getattr(lowered, f).shape) for f in scenarios.stacking.TABLE_FIELDS},
            "env_scenario": lowered.env_scenario.clone(),
            "block": shard.block(cfg.num_envs),
            "loss": metrics["loss"],
        }
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(world: int, tmp_path) -> list[dict]:
    ctx = mp.spawn(_worker, args=(world, f"file://{tmp_path}/pg", str(tmp_path)), nprocs=world, join=False)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {world}-rank group did not finish within {JOIN_TIMEOUT_S} s")
    assert not any(p.is_alive() for p in ctx.processes)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def unsharded() -> dict:
    return _train(None)


@pytest.fixture(scope="module", params=[1, 2], ids=["world1", "world2"])
def ranks(request, tmp_path_factory) -> list[dict]:
    return _spawn(request.param, tmp_path_factory.mktemp(f"world{request.param}"))


# ---------------------------------------------------------------------------
# the placement rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", [1, 2, 4])
def test_env_shardings_replicate_indivisible_leaves(world):
    tree = {"big": torch.ones((4 * world, 2)), "odd": torch.ones((3,)), "scalar": torch.tensor(1.0), "n": 5}
    how = env_shardings(tree, world)
    assert how["big"] == ("shard" if world > 1 else "replicate")
    assert how["odd"] == how["scalar"] == how["n"] == "replicate"
    shard = EnvShard(rank=world - 1, world=world, group=None, device=torch.device("cpu"))
    placed = place_env_batch(tree, shard)
    torch.testing.assert_close(placed["big"], tree["big"][4 * (world - 1) : 4 * world], rtol=0, atol=0)
    torch.testing.assert_close(placed["odd"], tree["odd"], rtol=0, atol=0)
    assert placed["n"] == 5


def test_place_env_batch_cuts_draws_and_keeps_their_structure():
    shard = EnvShard(rank=1, world=2, group=None, device=torch.device("cpu"))
    draws = ReplayDraws(ResetDraws(torch.arange(8)), [], [torch.arange(32)])
    cut = draws.envs(*shard.block(8))
    assert cut.reset.day.tolist() == [4, 5, 6, 7]
    assert cut.perms[0].tolist() == list(range(32))  # the permutation of the whole batch stays whole
    assert place_env_batch(ResetDraws(torch.arange(8)), shard).day.tolist() == [4, 5, 6, 7]


def test_make_shard_envs_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised torch.distributed"):
        make_shard_envs(device="cpu")


# ---------------------------------------------------------------------------
# sharded PPO against the single-process port
# ---------------------------------------------------------------------------
def test_sharded_make_train_matches_one_process(ranks, unsharded):
    world = len(ranks)
    assert [r["block"] for r in ranks] == [(r * 8 // world, (r + 1) * 8 // world) for r in range(world)]
    for r, got in enumerate(ranks):
        for name, want in unsharded["params"].items():
            torch.testing.assert_close(got["ppo"]["params"][name], want, **SHARD_TOL,
                                       msg=lambda m, r=r, name=name: f"rank {r} {name}: {m}")
        assert got["ppo"]["metrics"].keys() == unsharded["metrics"].keys()
        for name, want in unsharded["metrics"].items():
            assert want.shape == (UPDATES,)
            torch.testing.assert_close(got["ppo"]["metrics"][name], want, **SHARD_TOL,
                                       msg=lambda m, r=r, name=name: f"rank {r} metric {name}: {m}")


def test_scenario_tables_one_copy_per_scenario_on_each_rank(ranks):
    world = len(ranks)
    for r, got in enumerate(ranks):
        sc = got["scenarios"]
        assert all(shape[0] == len(SCEN_NAMES) for shape in sc["tables"].values()), sc["tables"]
        lo, hi = sc["block"]
        assert (lo, hi) == (r * 6 // world, (r + 1) * 6 // world)
        # each rank's rows come from the global env index b, through b // (B / S)
        assert sc["env_scenario"].tolist() == [b // 2 for b in range(lo, hi)]
        assert torch.isfinite(sc["loss"]).all()
    # the generator-driven update is one global-batch update: every rank reports the same loss
    for got in ranks[1:]:
        torch.testing.assert_close(got["scenarios"]["loss"], ranks[0]["scenarios"]["loss"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# a sharded fleet against the unsharded one
# ---------------------------------------------------------------------------
def test_sharded_fleet_rollout_matches_unsharded(ranks):
    world = len(ranks)
    s = len(FLEET_ARCHS)
    for r, got in enumerate(ranks):
        fl = got["fleet"]
        assert fl["local_replicas"] == FLEET_REPLICAS // world
        lo, hi = r * FLEET_REPLICAS // world * s, (r + 1) * FLEET_REPLICAS // world * s
        for k in ("reward", "obs", "fleet_reward"):
            torch.testing.assert_close(fl["sharded"][k], fl["full"][k][:, lo:hi], rtol=0, atol=0, msg=k)
        # a fleet count the group does not divide runs whole on every rank
        assert got["odd_fleet"] == (world > 1, (world + 1) * s)


# ---------------------------------------------------------------------------
# the errors
# ---------------------------------------------------------------------------
def _fake_shard(rank: int = 0, world: int = 2) -> EnvShard:
    return EnvShard(rank=rank, world=world, group=None, device=torch.device("cpu"))


def test_scenario_envs_must_divide():
    env = ChargaxEnv(ENV_CONFIG, device="cpu")
    stacked = scenarios.stack_params([scenarios.make(n).make_params(env) for n in SCEN_NAMES])
    with pytest.raises(ValueError, match="drop scenarios"):
        make_train(_ppo_config(num_envs=4), env, device="cpu", scenario_params=stacked, shard_envs=_fake_shard())


def test_num_envs_must_split_over_the_ranks():
    env = ChargaxEnv(ENV_CONFIG, device="cpu")
    with pytest.raises(ValueError, match="do not split over 2 ranks"):
        make_train(_ppo_config(num_envs=7), env, device="cpu", shard_envs=_fake_shard())


def test_rl_train_replicates_when_num_envs_does_not_divide(capsys):
    shard = _fake_shard()
    assert env_shard_for(7, shard) is None
    assert "not divisible by 2 devices — env sharding disabled, running replicated" in capsys.readouterr().out
    assert env_shard_for(8, shard) is shard
    assert env_shard_for(8, None) is None


def test_sharded_fleet_needs_no_group_and_shard_false_opts_out():
    fleet = FleetEnv(FLEET_ARCHS, ENV_CONFIG, replicas=2, device="cpu")
    assert fleet.env_shard is None and fleet.local_replicas == 2 and fleet.num_envs == 6
    assert fleet.with_shard(False).shard is False
    assert dataclasses.is_dataclass(fleet.default_params)
