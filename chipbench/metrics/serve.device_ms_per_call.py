"""Device milliseconds of the kernels launched inside ``eval/serve``, per call."""


def read(tr, info):
    ks = tr.under("eval/serve")
    return sum(k.dur for k in ks) / 1e3 / info["calls"] if ks and info.get("calls") else None
