"""Device milliseconds of the kernels whose innermost span is one of the
env's (``env/*``), per batched step."""


def read(tr, info):
    ks = tr.kernels(lambda s: s.startswith("env/"))
    return sum(k.dur for k in ks) / 1e3 / info["steps"] if ks and info.get("steps") else None
