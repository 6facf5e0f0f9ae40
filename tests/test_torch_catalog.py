"""The whole 25-scenario catalog stepped against the JAX package, env by env.

One fleet of 25 ``paper_16`` stations, one catalog scenario each (V2G on),
2 replicas: 50 envs over 300 steps (past the 288-step episode end), staged
and fused, on JAX's reset days, actions and per-station arrival draws
(``tests/test_torch_fleet.py``'s replay).  The fleet stacks each scenario's
tables once, so this is also every catalog lowering stepped through the
fleet's per-scenario reads.

Held env by env, as ``chip_smoke.py``'s phases 19 and 22 hold the card
against the CPU: an env *leaves* at the first step where its discrete state
(``occupied``, ``t_remain``, ``t``, ``day``) or its ``done`` differs from
JAX's, a last-ulp difference that a threshold (a charge-sensitive car's
departure at SoC 1.0, a deadline) decides the other way; at most
``ENVS_OFF`` of the 50 may leave, named in the failure message.  Every env
until it leaves, and every other env throughout, is held within
``test_torch_transition.EQ5`` (rtol 1e-4 / atol 2e-4) in its observation,
reward, info and state floats.  The running profit ``profit_cum`` is a sum
of 300 per-step profits, each held within ``EQ5``; its rounding grows with
the magnitudes the sum has passed through, not with its value (a peak
shaver's sum crosses zero after swinging by hundreds of EUR), so its rtol
applies to the largest magnitude the env's sum has reached.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro import scenarios as jscenarios
from repro.core import EnvConfig as JaxConfig
from repro.core import FleetEnv as JaxFleet
from repro_torch.core import EnvConfig, FleetEnv
from test_torch_fleet import _flat, jax_fleet_rollout, port_fleet_rollout
from test_torch_transition import EQ5

CATALOG = tuple(s.name for s in jscenarios.CATALOG)
REPLICAS, STEPS = 2, 300
# envs of the 50 that may leave JAX's trajectory on a last-ulp departure
# (such as a v2g_highway_peak_shaver car reaching SoC 1.0 on one side only)
ENVS_OFF = 3
DISCRETE = ("occupied", "t_remain", "t", "day")
FLOATS = ("soc", "e_remain", "evse_current", "batt_soc", "batt_current", "v2g_debt")
INFO = ("profit", "reward", "e_pv", "grid/power_drawn", "grid/cap", "grid/violation", "energy_discharged")


@functools.cache
def _jax_rollout(fused: bool):
    cfg = JaxConfig(allow_v2g=True, fused_step=fused)
    jfleet = JaxFleet(["paper_16"] * len(CATALOG), cfg, scenarios=list(CATALOG))
    return jax_fleet_rollout(jfleet, REPLICAS, STEPS, seed=25)


def _rows_close(got: torch.Tensor, want: np.ndarray) -> np.ndarray:
    g = got.numpy().reshape(got.shape[0], -1)
    w = np.asarray(want).reshape(got.shape[0], -1)
    return np.isclose(g, w, **EQ5).all(1)


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_catalog_fleet_matches_jax_env_by_env(fused):
    days, steps = _jax_rollout(fused)
    fleet = FleetEnv(
        ["paper_16"] * len(CATALOG),
        EnvConfig(allow_v2g=True, fused_step=fused),
        scenarios=list(CATALOG),
        replicas=REPLICAS,
        device="cpu",
    )
    b = fleet.num_envs
    # one copy of the tables per distinct set (scenarios that differ only in
    # other fields share theirs), never one per env
    assert 1 < fleet.default_params.price_buy_table.shape[0] <= len(CATALOG)
    left: dict[int, int] = {}  # env -> the step it left at
    bad: list[str] = []
    reached = np.zeros(b)  # the largest |profit_cum| of each env so far

    def check(t, ts, ts_j):
        obs, state, reward, done, info = ts
        obs_j, state_j, reward_j, done_j, info_j = ts_j
        same = done.numpy() == _flat(done_j)
        for f in DISCRETE:
            g = getattr(state, f).numpy().reshape(b, -1)
            same &= (g == _flat(getattr(state_j, f)).reshape(b, -1)).all(1)
        for e in np.flatnonzero(~same):
            left.setdefault(int(e), t)
        close = _rows_close(obs, _flat(obs_j)) & _rows_close(reward, _flat(reward_j))
        for f in FLOATS:
            close &= _rows_close(getattr(state, f), _flat(getattr(state_j, f)))
        for k in INFO:
            close &= _rows_close(info[k], _flat(info_j[k]))
        cum_j = _flat(state_j.profit_cum)
        reached[:] = np.maximum(reached, np.abs(cum_j))
        err = np.abs(state.profit_cum.numpy() - cum_j)
        close &= err <= EQ5["atol"] + EQ5["rtol"] * reached
        for e in np.flatnonzero(~close):
            if int(e) not in left:
                bad.append(f"env {e} ({CATALOG[e % len(CATALOG)]}) step {t}")

    state = port_fleet_rollout(fleet, days, steps, check=check)
    named = {f"env {e} ({CATALOG[e % len(CATALOG)]})": t for e, t in left.items()}
    assert not bad, f"fused={fused}: outside EQ5 before leaving: {bad[:10]}; left: {named}"
    assert len(left) <= ENVS_OFF, f"fused={fused}: {len(left)} envs left JAX's trajectory: {named}"
    assert (state.profit_cum != 0).all() and float(state.energy_discharged.sum()) > 0
