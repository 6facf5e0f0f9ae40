"""Chargax PPO training, the torch counterpart of ``repro.launch.rl_train``.

    PYTHONPATH=src python -m repro_torch.launch.rl_train --fused --device cpu \\
        --num-envs 4 --rollout 16 --timesteps 64
    PYTHONPATH=src python -m repro_torch.launch.rl_train --fused --num-envs 16384 \\
        --timesteps 19660800          # on the card: 4 updates of 16384 x 300
    PYTHONPATH=src python -m repro_torch.launch.rl_train --fused --v2g \\
        --num-envs 16384 --timesteps 19660800   # across the V2G mix, then its report
    PYTHONPATH=src python -m repro_torch.launch.rl_train --fused --num-envs 16384 \\
        --timesteps 4915200 --metrics-out results/ppo.jsonl --profile results/trace

trains the paper's actor-critic on a batch of stations and prints the
training rate and the rollout reward of the first and last update.
``--scenarios`` trains one agent across catalog scenarios (names and pack
names, comma-separated), after a preflight that their params share one step
(``--no-preflight`` skips it); ``--v2g`` lets cars discharge and, without
``--scenarios``, trains across the largest prefix of ``V2G_MIXED_PACK``
that divides ``--num-envs``, then reports the trained policy against the
max-charge and arbitrage baselines on the first scenario.
``--metrics-out PATH`` appends a run manifest, one ``train`` record and the
V2G report's ``eval`` records to a JSONL file; ``--profile DIR`` then
traces one short update (a probe) with its phases annotated and prints the
trace's path (open it at https://ui.perfetto.dev).  Without ``--device`` it
runs on the card, and raises where there is none.

Under ``torchrun --nproc_per_node W`` (``WORLD_SIZE`` > 1) each process
drives ``cuda:LOCAL_RANK`` in an NCCL group (gloo with ``--device cpu``) and
steps its block of ``num_envs // W`` envs of one global-batch PPO run
(``make_train(shard_envs=...)``); where W does not divide ``--num-envs``
every rank runs the whole batch, replicated.  Only rank 0 prints, writes
``--metrics-out`` and traces ``--profile`` (its probe: one unsharded
update on rank 0's card)::

    torchrun --nproc_per_node 4 -m repro_torch.launch.rl_train --fused --num-envs 65536
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch
import torch.distributed as dist

from repro_torch import obs, scenarios
from repro_torch.core import ChargaxEnv, EnvConfig
from repro_torch.core.state import EnvParams
from repro_torch.distributed import EnvShard, make_shard_envs
from repro_torch.rl import evaluate, make_ppo_policy
from repro_torch.rl.baselines import max_charge_policy, v2g_arbitrage_policy
from repro_torch.rl.ppo import PPOConfig, make_train

# the V2G report: episodes of the first scenario and the generator's seed
V2G_EVAL_EPISODES = 16
V2G_EVAL_SEED = 17


def expand_scenarios(spec: str) -> list[str]:
    """Expand ``--scenarios`` tokens: names pass through, pack names
    (``REAL_PACK``, ``GRID_PACK``, ``CITY_PACK``, ``V2G_PACK``,
    ``V2G_MIXED_PACK``, ``CATALOG``) expand to their members — so
    ``--scenarios REAL_PACK,shopping_flat`` trains across the real-data
    worlds plus the synthetic baseline in one distribution."""
    packs = {
        "REAL_PACK": scenarios.REAL_PACK,
        "GRID_PACK": scenarios.GRID_PACK,
        "CITY_PACK": scenarios.CITY_PACK,
        "V2G_PACK": scenarios.V2G_PACK,
        "V2G_MIXED_PACK": scenarios.V2G_MIXED_PACK,
        "CATALOG": tuple(s.name for s in scenarios.CATALOG),
    }
    names: list[str] = []
    for tok in spec.split(","):
        tok = tok.strip()
        names.extend(packs.get(tok, (tok,)))
    return names


def scenario_mix(spec: str | None, v2g: bool, num_envs: int) -> list[str] | None:
    """The scenarios to train across: ``--scenarios`` expanded, else with
    ``--v2g`` the largest ``V2G_MIXED_PACK`` prefix that divides
    ``num_envs`` (each scenario takes an even block of envs), else None."""
    if spec:
        return expand_scenarios(spec)
    if not v2g:
        return None
    pack = scenarios.V2G_MIXED_PACK
    n_scen = max(s for s in range(1, len(pack) + 1) if num_envs % s == 0)
    names = list(pack[:n_scen])
    print(f"[ppo] --v2g default mix: {','.join(names)}")
    return names


def stack_scenarios(env: ChargaxEnv, names: list[str], preflight: bool = True) -> EnvParams:
    """The named scenarios lowered onto ``env`` and stacked; with
    ``preflight``, first proved to share one step
    (:func:`repro_torch.obs.assert_one_compiled_step`)."""
    per_scenario = [scenarios.make(n).make_params(env) for n in names]
    stacked = scenarios.stack_params(per_scenario)
    print(f"[ppo] training across {len(names)} scenarios (one table copy each)")
    if preflight:
        obs.assert_one_compiled_step(env, per_scenario, label=f"scenarios {','.join(names)}")
        print(
            f"[obs] preflight: {len(per_scenario)} scenarios share one "
            "compiled step (no recompiles)"
        )
    return stacked


def profile_probe(
    args: argparse.Namespace, cfg: PPOConfig, env: ChargaxEnv, stacked: EnvParams | None
) -> str | None:
    """Trace ONE short PPO update into ``args.profile``; return the trace's path.

    The real run stays untraced: the profiler records every op and kernel.
    Every update runs the same code, so one update with a short rollout
    (``min(args.rollout, 8)`` steps) and one minibatch of one epoch is the
    profile, its phases (``env/*``, ``wrap/*``, ``ppo/*``) nested as the
    code runs them.
    """
    probe_rollout = min(args.rollout, 8)
    probe_cfg = PPOConfig(
        total_timesteps=cfg.num_envs * probe_rollout,
        num_envs=cfg.num_envs,
        rollout_steps=probe_rollout,
        num_minibatches=1,
        update_epochs=1,
        hidden=cfg.hidden,
    )
    gen = torch.Generator(device=env.device).manual_seed(args.seed)
    with obs.trace_session(args.profile, keep_xplane=False):
        with obs.annotate("profile/trace_and_compile"):
            probe = make_train(probe_cfg, env, scenario_params=stacked, device=env.device)
            runner = probe.init(gen)
        with obs.annotate("profile/run_one_update"):
            probe.update(runner)
            if env.device.type == "cuda":
                torch.cuda.synchronize(env.device)
    return obs.latest_trace(args.profile)


def v2g_report(
    env: ChargaxEnv, scenario: str, net, writer: obs.MetricsWriter | None = None
) -> dict[str, dict]:
    """The trained greedy policy against the always-max and arbitrage
    baselines over ``V2G_EVAL_EPISODES`` episodes of ``scenario``: profit,
    energy discharged from cars, discharge share and missing energy, each
    also an ``eval`` record tagged ``<scenario>/<policy>`` in ``writer``."""
    params = scenarios.make(scenario).make_params(env)
    policies = {
        "ppo": (make_ppo_policy(env), net),
        "max_charge": (max_charge_policy(env), None),
        "v2g_arbitrage": (v2g_arbitrage_policy(env, params), None),
    }
    results = {}
    for name, (policy, policy_params) in policies.items():
        gen = torch.Generator(device=env.device).manual_seed(V2G_EVAL_SEED)
        res = evaluate(
            env, policy, policy_params, gen, V2G_EVAL_EPISODES, env_params=params,
            writer=writer, tag=f"{scenario}/{name}", device=env.device,
        )
        print(
            f"[v2g eval] {scenario} {name}: "
            f"profit={res['daily_profit']:.1f} "
            f"discharged={res['energy_discharged_kwh']:.1f}kWh "
            f"discharge_frac={res['v2g_discharge_frac']:.3f} "
            f"missing={res['missing_kwh']:.1f}kWh"
        )
        results[name] = res
    return results


def join_group(args: argparse.Namespace) -> EnvShard | None:
    """Under ``torchrun`` (``WORLD_SIZE`` > 1): join the process group (NCCL
    on ``cuda:LOCAL_RANK``, gloo for ``--device cpu``), point ``args.device``
    at this rank's device and return its :class:`EnvShard`; None alone."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if args.device is None or torch.device(args.device).type == "cuda":
        args.device = f"cuda:{local}"
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=torch.device(args.device))
    else:
        dist.init_process_group("gloo")
    return make_shard_envs(device=args.device)


def env_shard_for(num_envs: int, shard: EnvShard | None) -> EnvShard | None:
    """The shard to train with: ``shard`` where its W ranks divide
    ``num_envs``; else None, every rank running the whole batch, after the
    JAX launcher's warning."""
    if shard is None:
        return None
    if num_envs % shard.world:
        print(
            f"[ppo] WARNING: num_envs={num_envs} not divisible by "
            f"{shard.world} devices — env sharding disabled, running replicated"
        )
        return None
    print(f"[ppo] sharding {num_envs} envs over {shard.world} devices")
    return shard


def run_train(args: argparse.Namespace) -> dict:
    shard = join_group(args)
    try:
        quiet = shard is not None and shard.rank > 0
        with open(os.devnull, "w") if quiet else contextlib.nullcontext() as sink:
            with contextlib.redirect_stdout(sink) if quiet else contextlib.nullcontext():
                return _run_train(args, shard)
    finally:
        if shard is not None:
            dist.destroy_process_group()


def _run_train(args: argparse.Namespace, shard: EnvShard | None) -> dict:
    rank0 = shard is None or shard.rank == 0
    if not rank0:
        args.metrics_out = args.profile = None
    env = ChargaxEnv(
        EnvConfig(
            scenario=args.scenario,
            traffic=args.traffic,
            allow_v2g=args.v2g,
            fused_step=args.fused,
        ),
        device=args.device,
    )
    # the fused step's route: the CUDA kernel on the card, its plain version elsewhere
    route = "cuda" if env.device.type == "cuda" else "plain"
    if args.fused:
        name = "the CUDA kernel" if route == "cuda" else "its plain version"
        print(f"[ppo] fused step kernel ON ({name} on {env.device})")
    print(f"[ppo] obs={env.observation_space} actions={env.action_space}")
    cfg = PPOConfig(
        total_timesteps=args.timesteps,
        num_envs=args.num_envs,
        rollout_steps=args.rollout,
    )
    names = scenario_mix(args.scenarios, args.v2g, args.num_envs)
    stacked = stack_scenarios(env, names, args.preflight) if names else None
    shard = env_shard_for(args.num_envs, shard)
    train = make_train(cfg, env, scenario_params=stacked, device=env.device, shard_envs=shard)
    t0 = time.perf_counter()
    out = train(torch.Generator(device=env.device).manual_seed(args.seed))
    metrics = {k: v.tolist() for k, v in out["metrics"].items()}  # waits for the device
    wall = time.perf_counter() - t0
    trace = profile_probe(args, cfg, env, stacked) if args.profile else None
    rr = metrics["rollout_reward"]
    print(
        f"[ppo] {args.timesteps:,} steps in {wall:.1f}s "
        f"({args.timesteps / wall:,.0f} env-steps/s) | "
        f"reward first->last: {rr[0]:.1f} -> {rr[-1]:.1f}"
    )
    kpis = {k.split("/", 1)[1]: v[-1] for k, v in metrics.items() if k.startswith("kpi/")}
    if kpis:
        print(
            "[kpi] last update, per env-step: "
            + " ".join(f"{k}={v:.3f}" for k, v in sorted(kpis.items()))
        )
    if args.profile:
        print(
            f"[obs] profile trace: {trace} "
            "(open at https://ui.perfetto.dev — phases env/*, wrap/*, ppo/*)"
        )
    sink = (
        obs.MetricsWriter(
            args.metrics_out,
            run="rl_train",
            scenario=args.scenario,
            scenarios=names,
            timesteps=args.timesteps,
            num_envs=cfg.num_envs,
            seed=args.seed,
            fused_step=args.fused,
            fused_impl=route if args.fused else None,
            backend=env.device.type,
            device_kind=obs.sinks.device_kind(env.device),
        )
        if args.metrics_out
        else contextlib.nullcontext()
    )
    with sink as writer:
        if writer is not None:
            writer.write(
                {
                    "wall_s": round(wall, 2),
                    "env_steps_per_sec": round(args.timesteps / wall, 1),
                    "rollout_reward_first": rr[0],
                    "rollout_reward_last": rr[-1],
                    "episode_return_last": metrics["episode_return"][-1],
                    **{f"kpi/{k}": v for k, v in kpis.items()},
                },
                kind="train",
            )
        if args.v2g and names and rank0:
            out["v2g_eval"] = v2g_report(env, names[0], out["runner_state"].params, writer)
    if args.metrics_out:
        print(f"[obs] metrics JSONL: {args.metrics_out}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--scenarios",
        default=None,
        help="comma-separated catalog scenarios to train across (num-envs must be "
        "a multiple of their count); pack names REAL_PACK / GRID_PACK / CITY_PACK / "
        "V2G_PACK / V2G_MIXED_PACK / CATALOG expand",
    )
    ap.add_argument("--scenario", default="shopping")
    ap.add_argument("--traffic", default="medium")
    ap.add_argument(
        "--v2g",
        action="store_true",
        help="allow car discharging (EnvConfig.allow_v2g); without --scenarios "
        "this trains across the bundled mixed v2g/non-v2g pack",
    )
    ap.add_argument(
        "--fused",
        action="store_true",
        help="route the env step through the fused step kernel (EnvConfig.fused_step; "
        "the CUDA kernel on the card, its plain version on the CPU)",
    )
    ap.add_argument("--timesteps", type=int, default=300_000)
    ap.add_argument("--num-envs", type=int, default=12)
    ap.add_argument("--rollout", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="after training, trace one short update to DIR with its phases annotated "
        "(env/*, wrap/*, ppo/*; open at ui.perfetto.dev)",
    )
    ap.add_argument(
        "--metrics-out",
        default=None,
        metavar="PATH",
        help="append run manifest + train/eval KPI records to a JSONL sink",
    )
    ap.add_argument(
        "--preflight",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="with --scenarios/--v2g: check the scenarios share ONE step before "
        "training; --no-preflight skips",
    )
    return run_train(ap.parse_args(argv))


if __name__ == "__main__":
    main()
