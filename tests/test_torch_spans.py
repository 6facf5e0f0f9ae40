"""Where the port's phase spans (``repro_torch.obs.annotate``) fall, on the
CPU under ``torch.profiler``: every op of a fused env step is inside an
``env/*`` span (the sampler's draws in ``env/sample``, the clock in
``env/advance``, the ``info`` dict in ``env/info``); every op of
``run_episodes``' loop is inside ``env/*`` or ``policy/act`` but the reward
accumulation; ``FleetAdapter``'s own ops are FleetEnv's per-fleet sums; the
PPO rollout's forward and sample are in ``policy/act``.  Disabled, the
evaluation loop never reaches the profiler.

A device trace puts each kernel in the innermost span open at its launch;
the host ops here stand in for those launches.
"""
from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import obs
from repro_torch.core import ChargaxEnv, EnvConfig
from repro_torch.core.fleet import FleetEnv
from repro_torch.envs.wrappers import FleetAdapter
from repro_torch.rl.eval import make_ppo_policy, run_episodes
from repro_torch.rl.networks import ActorCritic
from repro_torch.rl.ppo import PPOConfig, make_train

CALL = "test/call"  # the span the test opens around the call under trace
# one hour of five-minute steps: a short episode
SHORT = dict(fused_step=True, episode_hours=1.0)
# what FleetEnv's per-fleet sums launch: the sum and the views of its reshape
FLEET_SUM_OPS = {"aten::sum", "aten::fill_", "aten::reshape", "aten::view", "aten::expand", "aten::as_strided",
                 "aten::clone", "aten::empty_like", "aten::empty", "aten::copy_", "aten::_unsafe_view"}


def _traced(tmp_path, fn) -> list[tuple[str, str]]:
    """``fn()`` under the CPU profiler with the spans on: each op that starts
    inside it, with the innermost span open when it started."""
    prev = obs.enable_trace_annotations(True)
    try:
        with profile(activities=[ProfilerActivity.CPU], record_shapes=False) as prof:
            with record_function(CALL):
                fn()
    finally:
        obs.enable_trace_annotations(prev)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"], e["name"])
             for e in events if e.get("cat") == "user_annotation"]
    (c0, c1, ctid, _), = [s for s in spans if s[3] == CALL]
    out = []
    for e in events:
        ts = float(e["ts"])
        if e.get("cat") != "cpu_op" or e["tid"] != ctid or not c0 <= ts <= c1:
            continue
        # the innermost: the last to start, the shorter where two start together
        held = [s for s in spans if s[2] == ctid and s[0] <= ts <= s[1]]
        out.append((e["name"], max(held, key=lambda s: (s[0], -s[1]))[3]))
    return out


def _env_and_state(num_envs: int = 3):
    env = ChargaxEnv(EnvConfig(**SHORT), device="cpu")
    gen = torch.Generator().manual_seed(0)
    _, state = env.reset(gen, num_envs=num_envs)
    return env, gen, state


def test_every_op_of_a_fused_env_step_is_in_an_env_span(tmp_path):
    env, gen, state = _env_and_state()
    action = torch.randint(0, env.num_actions_per_head, (3, env.num_action_heads), generator=gen)
    ops = _traced(tmp_path, lambda: env.step(gen, state, action))
    assert ops
    assert [(op, span) for op, span in ops if not span.startswith("env/")] == []
    seen = {span for _, span in ops}
    assert {"env/sample", "env/advance", "env/info"} <= seen
    # advance_time's midnight test and price-row select are the clock's
    assert {"aten::remainder", "aten::where"} <= {op for op, span in ops if span == "env/advance"}


def test_injected_draws_open_no_sampler_span(tmp_path):
    from repro_torch.core import sampling

    env, gen, state = _env_and_state()
    action = torch.zeros((3, env.num_action_heads), dtype=torch.long)
    # the arrivals a generator would give, drawn beforehand and handed in
    draws = sampling.draw_arrivals(env.default_params, state, torch.Generator().manual_seed(1))
    ops = _traced(tmp_path, lambda: env.step(draws, state, action))
    spans = {span for _, span in ops}
    assert "env/sample" not in spans and {"env/depart_arrive", "env/advance", "env/info"} <= spans
    assert all(span.startswith("env/") for span in spans)


def test_every_op_of_the_evaluation_loop_is_in_the_env_or_the_policy(tmp_path):
    env = ChargaxEnv(EnvConfig(**SHORT), device="cpu")
    net = ActorCritic(env.obs_dim, env.num_action_heads, env.num_actions_per_head)
    policy = make_ppo_policy(env, greedy=True)
    gen = torch.Generator().manual_seed(0)
    ops = _traced(tmp_path, lambda: run_episodes(env, policy, net, gen, num_episodes=2, device="cpu"))
    steps = env.config.episode_steps
    rollout_own = [op for op, span in ops if span == "eval/rollout"]
    # the reward accumulation, once a step, is the rollout's only op of its own
    assert rollout_own == ["aten::add_"] * steps
    in_loop = [(op, span) for op, span in ops if span not in (CALL, "eval/rollout")]
    assert in_loop and all(span.startswith("env/") or span == "policy/act" for _, span in in_loop)
    acting = {op for op, span in ops if span == "policy/act"}
    assert {"aten::addmm", "aten::argmax"} <= acting


def test_fleet_adapters_own_ops_are_the_per_fleet_sums(tmp_path):
    fleet = FleetEnv(["paper_16", "deep_4x4", "single_dc_8"], EnvConfig(**SHORT), replicas=2, device="cpu")
    env = FleetAdapter(fleet)
    gen = torch.Generator().manual_seed(0)
    _, state = env.reset(gen)
    action = fleet.sample_action(gen)
    ops = _traced(tmp_path, lambda: env.step(gen, state, action))
    own = [op for op, span in ops if span == "wrap/FleetAdapter"]
    # two sums: fleet_reward and fleet_profit
    assert own.count("aten::sum") == 2 and set(own) <= FLEET_SUM_OPS, own
    assert [(op, span) for op, span in ops if span != "wrap/FleetAdapter" and not span.startswith("env/")] == []
    assert {"env/sample", "env/advance", "env/info"} <= {span for _, span in ops}
    # the uncoupled fleet takes the fused route and has no feeder
    assert not {"fleet/feeder", "env/allocate"} & {span for _, span in ops}


def _coupled_fleet():
    """The repository's grid benchmark's fleet: four stations behind one
    300 kW feeder, two fleets of them."""
    fleet = FleetEnv(["paper_16", "deep_4x4", "paper_16", "mixed_8_8"], EnvConfig(**SHORT),
                     scenarios=["grid_tight_transformer"] * 4, couple_grid=True, replicas=2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    _, state = fleet.reset(gen)
    return fleet, gen, state, fleet.sample_action(gen)


def test_the_coupled_fleets_allocation_and_feeder_are_in_their_spans(tmp_path):
    from repro_torch.core import transition

    fleet, gen, state, action = _coupled_fleet()
    ops = _traced(tmp_path, lambda: FleetAdapter(fleet).step(gen, state, action))
    # every op of the stations' allocation is in env/allocate: the same ops as the call alone
    params = fleet.default_params
    applied = fleet.template.request_stage(state, action, params)
    alone = _traced(tmp_path, lambda: transition.allocate(params, state, applied))
    assert sorted(op for op, span in ops if span == "env/allocate") == sorted(op for op, _ in alone)
    # the feeder's per-fleet sum, scale, curtailment, cap and attribution are in fleet/feeder
    feeder = [op for op, span in ops if span == "fleet/feeder"]
    assert {"aten::sum", "aten::clamp", "aten::div", "aten::where", "aten::minimum", "aten::mul"} <= set(feeder)
    # so FleetAdapter's own ops are the per-fleet sums alone, and nothing lies outside a span
    own = [op for op, span in ops if span == "wrap/FleetAdapter"]
    assert own.count("aten::sum") == 2 and set(own) <= FLEET_SUM_OPS, own
    assert [(op, span) for op, span in ops
            if span not in ("wrap/FleetAdapter", "fleet/feeder") and not span.startswith("env/")] == []
    assert {"env/apply_actions", "env/charge_cars", "env/sample"} <= {span for _, span in ops}
    assert "env/fused_transition" not in {span for _, span in ops}


def test_the_coupled_fleets_spans_change_no_number():
    fleet, _, state, action = _coupled_fleet()
    steps = []
    for on in (False, True):
        prev = obs.enable_trace_annotations(on)
        try:
            steps.append(fleet.step(torch.Generator().manual_seed(5), state, action))
        finally:
            obs.enable_trace_annotations(prev)
    (_, off_state, off_reward, _, off_info), (_, on_state, on_reward, _, on_info) = steps
    assert torch.equal(off_reward, on_reward) and torch.equal(off_state.evse_current, on_state.evse_current)
    assert torch.equal(off_info["grid/violation"], on_info["grid/violation"])
    # the feeder bound: the fleets draw at most the cap, 300 kW each
    drawn = off_info["grid/power_drawn"].reshape(-1, 4).sum(1)
    assert bool((drawn <= 300.0 * (1 + 1e-6)).all())


def test_the_ppo_rollout_acts_inside_policy_act(tmp_path):
    env = ChargaxEnv(EnvConfig(**SHORT), device="cpu")
    cfg = PPOConfig(num_envs=4, rollout_steps=4, total_timesteps=16, num_minibatches=1, update_epochs=1)
    train = make_train(cfg, env, device="cpu")
    runner = train.init(torch.Generator().manual_seed(0))
    ops = _traced(tmp_path, lambda: train.rollout(runner))
    acting = [op for op, span in ops if span == "policy/act"]
    # the actor's and the critic's three layers each, a step
    assert acting.count("aten::addmm") == 6 * cfg.rollout_steps
    assert "aten::argmax" in acting
    assert not [op for op, span in ops if op == "aten::addmm" and span != "policy/act"]


def test_disabled_evaluation_loop_never_reaches_the_profiler(monkeypatch):
    def boom(name):
        raise AssertionError(f"record_function({name!r}) called while disabled")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not obs.trace_annotations_enabled()
    env = ChargaxEnv(EnvConfig(**SHORT), device="cpu")
    net = ActorCritic(env.obs_dim, env.num_action_heads, env.num_actions_per_head)
    gen = torch.Generator().manual_seed(0)
    _, reward = run_episodes(env, make_ppo_policy(env, greedy=True), net, gen, num_episodes=2, device="cpu")
    assert reward.shape == (2,) and torch.isfinite(reward).all()
    prev = obs.enable_trace_annotations(True)
    try:  # enabled, annotate does reach it: the patch was in force
        with pytest.raises(AssertionError, match="called while disabled"):
            obs.annotate("policy/act")
    finally:
        obs.enable_trace_annotations(prev)
