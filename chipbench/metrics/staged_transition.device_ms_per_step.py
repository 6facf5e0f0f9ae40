"""Device milliseconds of the kernels whose innermost span is one of the
staged route's request -> allocate -> deliver (``env/apply_actions``,
``env/allocate``, ``env/charge_cars``), the work the fused kernel does on
the fused route, per batched step."""

SPANS = ("env/apply_actions", "env/allocate", "env/charge_cars")


def read(tr, info):
    ks = tr.kernels(lambda s: s in SPANS)
    return sum(k.dur for k in ks) / 1e3 / info["steps"] if ks and info.get("steps") else None
