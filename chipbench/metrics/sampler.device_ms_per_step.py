"""Device milliseconds of the kernels whose innermost span is ``env/sample``
(the program's arrival draws, inside ``env/depart_arrive``), per batched step."""


def read(tr, info):
    ks = tr.kernels("env/sample")
    return sum(k.dur for k in ks) / 1e3 / info["steps"] if ks and info.get("steps") else None
