"""Pure-Python/numpy reference implementation of the Chargax MDP (the JAX
package's ``benchmarks/python_ref_env.py``, kept as the port's own copy).

This is the Table-2 comparison baseline: the *same* environment semantics
written the way CPU gym environments are written (per-env Python object,
numpy scalar math, host RNG).  EV2Gym/Chargym/SustainGym are not installable
offline; this is the generous stand-in: it has no gym-wrapper overhead and
implements the identical transition, so the measured speedup is attributable
to the batched env on the card, not to API differences.  It stays pure numpy
on the host: its default params come from the port's ``ChargaxEnv`` on the
CPU, its tables from :mod:`repro_torch.core.datasets`, and one seed gives the
JAX package's observations, rewards, dones and infos to the bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import ChargaxEnv, EnvConfig
from repro_torch.core.datasets import (
    arrival_rate_curve,
    car_table,
    price_profile,
    user_profile_params,
)


class PythonChargax:
    """Single-environment, object-style port of ChargaxEnv."""

    def __init__(self, config: EnvConfig | None = None, seed: int = 0):
        self.cfg = config or EnvConfig()
        p = ChargaxEnv(self.cfg, device="cpu").default_params
        self.member = p.member.numpy()
        self.node_budget = p.node_budget.numpy()
        self.voltage = p.evse_voltage.numpy()
        self.imax = p.evse_max_current.numpy()
        self.path_eff = p.evse_path_eff.numpy()
        self.is_dc = p.evse_is_dc.numpy()
        self.n = len(self.voltage)
        self.batt = dict(
            v=float(p.batt_voltage), imax=float(p.batt_max_current),
            cap=float(p.batt_capacity), eff=float(p.batt_eff),
            tau=float(p.batt_tau), soc0=float(p.batt_init_soc),
        )
        self.prices = price_profile(self.cfg.price_region, self.cfg.price_year, self.cfg.dt_minutes)
        self.arrivals = arrival_rate_curve(self.cfg.scenario, self.cfg.traffic, self.cfg.dt_minutes)
        self.cars = car_table(self.cfg.car_region)
        self.user = user_profile_params(self.cfg.scenario)
        self.p_sell, self.sell_disc, self.c_dt = 0.75, 0.9, 0.25
        self.dt = self.cfg.dt_hours
        self.rng = np.random.default_rng(seed)
        self.spd = self.cfg.steps_per_day

    # ------------------------------------------------------------------
    def reset(self):
        self.t = 0
        self.day = int(self.rng.integers(0, 365))
        self.price_day = self.prices[self.day]
        n = self.n
        self.occ = np.zeros(n)
        self.cur = np.zeros(n)
        self.soc = np.zeros(n)
        self.e_rem = np.zeros(n)
        self.t_rem = np.zeros(n, np.int64)
        self.cap = np.zeros(n)
        self.rbar = np.zeros(n)
        self.tau = np.zeros(n)
        self.utype = np.zeros(n)
        self.b_soc = self.batt["soc0"]
        self.b_cur = 0.0
        return self._obs()

    def _obs(self):
        # observation content mirrors ChargaxEnv.observe (shape parity only):
        # 8 features per port; the 5th (v2g_debt/cap) is always 0 here, the
        # reference env has no V2G settlement
        feats = []
        for i in range(self.n):
            feats += [
                self.occ[i], self.cur[i] / self.imax[i], self.soc[i],
                self.e_rem[i] / max(self.cap[i], 1.0),
                0.0,  # v2g_debt / cap
                np.clip(self.t_rem[i] / self.spd, -1, 1),
                self._rhat(i) / self.imax[i], self.utype[i],
            ]
        feats += [self.b_soc, self.b_cur / self.batt["imax"]]
        ph = 2 * np.pi * self.t / self.spd
        feats += [np.sin(ph), np.cos(ph), float(self.day % 7 < 5), self.day / 365.0]
        idx = self.t % self.spd
        feats += [self.price_day[idx], self.price_day[idx], float(self.price_day.mean())]
        return np.array(feats, np.float32)

    def _rhat(self, i, soc=None):
        soc = self.soc[i] if soc is None else soc
        if self.occ[i] < 0.5:
            return 0.0
        if soc <= self.tau[i]:
            return self.rbar[i]
        return self.rbar[i] * (1 - soc) / max(1 - self.tau[i], 1e-6)

    # ------------------------------------------------------------------
    def step(self, action: np.ndarray):
        d = self.cfg.discretization
        frac = (action.astype(np.float64) - d) / d
        port_t = np.maximum(frac[:-1], 0.0) * self.imax
        batt_t = frac[-1] * self.batt["imax"]

        # stage 1: clips per port
        cur = np.zeros(self.n)
        for i in range(self.n):
            if self.occ[i] < 0.5:
                continue
            amp_per_kwh = 1000.0 / (self.voltage[i] * self.dt)
            up = min(
                self._rhat(i), self.imax[i],
                self.e_rem[i] * amp_per_kwh,
                (1 - self.soc[i]) * self.cap[i] * amp_per_kwh,
            )
            cur[i] = np.clip(port_t[i], 0.0, max(up, 0.0))
        # battery
        b = self.batt
        bsoc = self.b_soc
        b_chg = b["imax"] if bsoc <= b["tau"] else b["imax"] * (1 - bsoc) / (1 - b["tau"])
        b_dis = b["imax"] if (1 - bsoc) <= b["tau"] else b["imax"] * bsoc / (1 - b["tau"])
        apk = 1000.0 / (b["v"] * self.dt)
        b_up = min(b_chg, (1 - bsoc) * b["cap"] * apk / b["eff"])
        b_dn = min(b_dis, bsoc * b["cap"] * b["eff"] * apk)
        b_cur = float(np.clip(batt_t, -b_dn, b_up))

        # Eq. 5 rescale
        leaf = np.append(cur, b_cur)
        load = self.member @ np.abs(leaf)
        s_node = np.minimum(1.0, self.node_budget / np.maximum(load, 1e-9))
        excess = float(np.max(np.maximum(load - self.node_budget, 0.0)))
        scale = np.ones(self.n + 1)
        for k in range(len(self.node_budget)):
            mask = self.member[k] > 0
            scale[mask] = np.minimum(scale[mask], s_node[k])
        leaf *= scale
        cur, b_cur = leaf[:-1], leaf[-1]

        # stage 2: charge
        e_car = self.voltage * cur * self.dt / 1000.0
        self.soc = np.clip(self.soc + e_car / np.maximum(self.cap, 1e-6), 0, 1)
        self.e_rem = np.maximum(self.e_rem - e_car, 0.0)
        self.t_rem -= 1
        self.cur = cur
        e_b = b["v"] * b_cur * self.dt / 1000.0
        self.b_soc = np.clip(
            self.b_soc + (e_b * b["eff"] if e_b >= 0 else e_b / b["eff"]) / b["cap"], 0, 1
        )
        self.b_cur = b_cur

        # stage 3: departures
        missing = over = 0.0
        for i in range(self.n):
            if self.occ[i] < 0.5:
                continue
            leave = (self.utype[i] < 0.5 and self.t_rem[i] <= 0) or (
                self.utype[i] >= 0.5 and self.e_rem[i] <= 1e-6
            )
            if leave:
                if self.utype[i] < 0.5:
                    missing += max(self.e_rem[i], 0.0)
                else:
                    over += max(-self.t_rem[i], 0)
                self.occ[i] = self.cur[i] = self.soc[i] = self.e_rem[i] = 0.0
                self.cap[i] = self.rbar[i] = self.tau[i] = self.utype[i] = 0.0
                self.t_rem[i] = 0

        # stage 4: arrivals
        rate = self.arrivals[self.t % self.spd]
        m = int(self.rng.poisson(rate))
        free = [i for i in range(self.n) if self.occ[i] < 0.5]
        rejected = max(m - len(free), 0)
        for j in range(min(m, len(free))):
            i = free[j]
            row = self.cars[self.rng.choice(len(self.cars), p=self.cars[:, 0])]
            _, cap_kwh, ac_kw, dc_kw, tau = row
            kw = dc_kw if self.is_dc[i] > 0.5 else ac_kw
            stay_mu, stay_sig = self.user["stay"]
            stay_h = float(
                np.exp(np.log(stay_mu) - 0.5 * stay_sig**2 + stay_sig * self.rng.normal())
            )
            soc0 = float(np.clip(self.rng.beta(*self.user["soc0"]), 0.02, 0.95))
            tgt = float(
                np.clip(
                    self.user["target"][0] + self.user["target"][1] * self.rng.normal(),
                    soc0 + 0.05, 1.0,
                )
            )
            self.occ[i] = 1.0
            self.soc[i] = soc0
            self.cap[i] = cap_kwh
            self.rbar[i] = kw * 1000.0 / self.voltage[i]
            self.tau[i] = tau
            self.e_rem[i] = (tgt - soc0) * cap_kwh
            self.t_rem[i] = max(int(stay_h * self.spd / 24), 1)
            self.utype[i] = 0.0 if self.rng.random() < self.user["p_time_sensitive"] else 1.0

        # reward (Eq. 1-3, alpha = 0)
        e_net = float(e_car.sum())
        e_in = float(np.where(e_car > 0, e_car / self.path_eff, 0).sum())
        e_out = float(np.where(e_car < 0, e_car * self.path_eff, 0).sum())
        e_grid = e_in + e_out + e_b
        p_buy = float(self.price_day[self.t % self.spd])
        grid_cost = p_buy * e_grid if e_grid > 0 else self.sell_disc * p_buy * e_grid
        reward = self.p_sell * e_net - grid_cost - self.c_dt

        self.t += 1
        done = self.t >= self.cfg.episode_steps
        return self._obs(), reward, done, {"rejected": rejected, "missing": missing}

    def sample_action(self):
        return self.rng.integers(0, 2 * self.cfg.discretization + 1, self.n + 1)
