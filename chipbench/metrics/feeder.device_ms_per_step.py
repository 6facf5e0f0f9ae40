"""Device milliseconds of the kernels whose innermost span is ``fleet/feeder``
(a grid-coupled fleet's shared feeder: the per-fleet sums, the pro-rata
curtailment and the excess attributed by draw), per batched step."""


def read(tr, info):
    ks = tr.kernels("fleet/feeder")
    return sum(k.dur for k in ks) / 1e3 / info["steps"] if ks and info.get("steps") else None
