"""Device milliseconds of the kernels whose innermost span is ``env/advance``
(the clock, the midnight price-row reload and ``done``), per batched step."""


def read(tr, info):
    ks = tr.kernels("env/advance")
    return sum(k.dur for k in ks) / 1e3 / info["steps"] if ks and info.get("steps") else None
