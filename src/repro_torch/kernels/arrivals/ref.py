"""The plain version of the arrivals kernel: one step's arrival draws made
by PyTorch's own samplers from a ``torch.Generator``.

A CPU tensor or a CPU generator takes this route, so CPU draws are the
generator's bits as they always were.  On the card the same draws take
eight library calls and their copies (24 kernels a step at 262144 envs),
which ``csrc/arrivals.cu`` makes in one launch.
"""
from __future__ import annotations

import torch

from repro_torch.core import sampling
from repro_torch.core.state import EnvParams, EnvState, per_port

Tensor = torch.Tensor


def draw_arrivals_ref(
    params: EnvParams,
    state: EnvState,
    generator: torch.Generator,
    rate_extra: Tensor | None = None,
) -> sampling.ArrivalDraws:
    """Draw one step's arrivals from ``generator`` (on the state's device),
    the Poisson count at :func:`repro_torch.core.sampling.arrival_rate`
    with ``rate_extra``."""
    m = torch.poisson(sampling.arrival_rate(params, state, rate_extra), generator=generator)
    return draw_cars_ref(params, state.day, state.occupied.shape[1], m.to(torch.int32), generator)


def draw_cars_ref(
    params: EnvParams, day: Tensor, n: int, m: Tensor, generator: torch.Generator
) -> sampling.ArrivalDraws:
    """The arrivals' per-port draws for envs on ``day`` (B,) with ``n``
    ports, beside their given counts ``m``: none of these depends on the
    arrival rate."""
    b, dev = day.shape[0], day.device
    model = torch.multinomial(sampling.car_probs(params, day), n, replacement=True, generator=generator)
    z_stay = torch.randn((b, n), generator=generator, device=dev)
    # Beta(a, b) as X / (X + Y) with X ~ Gamma(a), Y ~ Gamma(b)
    def ports(field: Tensor) -> Tensor:
        return per_port(field).expand(b, n).contiguous()

    x = torch._standard_gamma(ports(params.soc0_a), generator=generator)
    y = torch._standard_gamma(ports(params.soc0_b), generator=generator)
    z_tgt = torch.randn((b, n), generator=generator, device=dev)
    bern = torch.bernoulli(ports(params.p_time_sensitive), generator=generator)
    return sampling.ArrivalDraws(m=m, model=model, z_stay=z_stay, soc0=x / (x + y), z_tgt=z_tgt, bern=bern > 0.5)
