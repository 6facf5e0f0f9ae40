"""Device milliseconds of the kernels whose innermost span is
``wrap/FleetAdapter`` (the fleet's own work around the env step), per step."""


def read(tr, info):
    ks = tr.kernels("wrap/FleetAdapter")
    return sum(k.dur for k in ks) / 1e3 / info["steps"] if ks and info.get("steps") else None
