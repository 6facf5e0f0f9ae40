"""Every random input of a run, made by the benchmark from ``--seed``.

Each draw comes from a generator on the run's device seeded afresh from
``(seed, stream, *index)``, so any one of them (a step's arrivals, an
episode's days, an update's permutations) can be made again after the
window, for the reference, without replaying the others.  The program gets
them through its draw seams (the env's ``ResetDraws`` / ``ArrivalDraws``,
PPO's ``ReplayDraws``), the reference gets the same tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from chipbench.reference.state import EnvParams, per_port, scenario_rows

Tensor = torch.Tensor
_MASK64 = (1 << 64) - 1

# the draw streams: one per kind of input, so that no two share a seed
STREAMS = {"weights": 1, "reset": 2, "arrivals": 3, "gumbel": 4, "perm": 5,
           "obs": 7, "rows": 8, "check": 9, "episodes": 10}


def _mix(x: int) -> int:
    """splitmix64's finaliser: a well-spread 64-bit hash of ``x``."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def key(seed: int, stream: str, *index: int) -> int:
    """A 63-bit seed for one draw of ``stream`` at ``index`` under ``seed``
    (any whole number, a large one too)."""
    h = _mix(int(seed) & _MASK64 ^ (int(seed) >> 64))
    for i in (STREAMS[stream], *index):
        h = _mix(h ^ (int(i) & _MASK64))
    return h >> 1


def generator(device: torch.device, seed: int, stream: str, *index: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(key(seed, stream, *index))


def reseed(gen: torch.Generator, seed: int, stream: str, *index: int) -> torch.Generator:
    """``gen`` seeded for one draw, without making a new generator."""
    return gen.manual_seed(key(seed, stream, *index))


@dataclasses.dataclass(frozen=True)
class Tables:
    """What the arrival draws read, float32, from the reference's params."""

    arrival_rate: Tensor  # (spd,) or (S, spd)
    arrival_day_scale: Tensor  # (365,) or (S, 365)
    car_cdf: Tensor  # (M,) cumulative model probabilities, or (S, 365, M) for a fleet
    soc0_a: Tensor  # 0-d or (B,)
    soc0_b: Tensor
    p_time_sensitive: Tensor
    env_scenario: Tensor | None  # (B,) for a fleet, else None

    @classmethod
    def of(cls, p: EnvParams) -> "Tables":
        f = lambda x: x.float()  # noqa: E731
        cdf = p.car_probs.double().cumsum(-1)
        cdf = cdf / cdf[..., -1:]
        return cls(f(p.arrival_rate), f(p.arrival_day_scale), f(cdf), f(p.soc0_a),
                   f(p.soc0_b), f(p.p_time_sensitive), p.env_scenario)


def day_at(day0: Tensor, t: int, spd: int, n_days: int = 365) -> Tensor:
    """Each env's day at step ``t`` of an episode that started on ``day0``."""
    return torch.remainder(day0 + t // spd, n_days).to(torch.int32)


def reset_days(n: int, gen: torch.Generator, n_days: int = 365) -> Tensor:
    """Exploring starts: a day of the price year per env, (n,) int32."""
    return torch.randint(0, n_days, (n,), generator=gen, device=gen.device, dtype=torch.int32)


def arrivals(tab: Tables, day: Tensor, t: int, n_ports: int, gen: torch.Generator) -> dict[str, Tensor]:
    """One step's arrival draws for envs on ``day`` at step ``t``: the
    Poisson count at the time-of-day rate, and per port a car model, stay
    and target noise, an arrival SoC and a user-type coin (the fields of the
    program's ``ArrivalDraws``, in its dtypes)."""
    b, dev = day.shape[0], day.device
    p = _Rows(tab.env_scenario)
    spd = tab.arrival_rate.shape[-1]
    t_idx = torch.full((b,), t % spd, dtype=torch.long, device=dev)
    rate = scenario_rows(p, tab.arrival_rate, t_idx) * scenario_rows(
        p, tab.arrival_day_scale, torch.remainder(day, tab.arrival_day_scale.shape[-1]).long()
    )
    m = torch.poisson(rate, generator=gen).to(torch.int32)
    # the car model by the inverse of its distribution's CDF: one CDF for all
    # envs, or each env's row of its scenario and day
    cdf = tab.car_cdf
    if cdf.dim() > 1:
        cdf = scenario_rows(p, cdf, torch.remainder(day, cdf.shape[-2]).long()).contiguous()
    u = torch.rand((b, n_ports), generator=gen, device=dev)
    model = torch.searchsorted(cdf, u, right=True).clamp_max(cdf.shape[-1] - 1)
    z_stay = torch.randn((b, n_ports), generator=gen, device=dev)

    def ports(x: Tensor) -> Tensor:
        return per_port(x).expand(b, n_ports).contiguous()

    x = torch._standard_gamma(ports(tab.soc0_a), generator=gen)
    y = torch._standard_gamma(ports(tab.soc0_b), generator=gen)
    z_tgt = torch.randn((b, n_ports), generator=gen, device=dev)
    bern = torch.bernoulli(ports(tab.p_time_sensitive), generator=gen) > 0.5
    return dict(m=m, model=model, z_stay=z_stay, soc0=x / (x + y), z_tgt=z_tgt, bern=bern)


@dataclasses.dataclass(frozen=True)
class _Rows:
    """What ``scenario_rows`` reads of the params: each env's scenario."""

    env_scenario: Tensor | None


def gumbel(shape: tuple[int, ...], gen: torch.Generator) -> Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, float32."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return -torch.log(-torch.log(u))


def rows(n: int, k: int, seed: int, device: torch.device) -> Tensor:
    """``k`` distinct env rows of ``n``, drawn from the seed, sorted."""
    g = generator(device, seed, "rows")
    return torch.randperm(n, generator=g, device=device)[: min(k, n)].sort().values
