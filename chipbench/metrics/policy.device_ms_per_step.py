"""Device milliseconds of the kernels whose innermost span is ``policy/act``
(the actor's forward and its action), per batched step."""


def read(tr, info):
    ks = tr.kernels("policy/act")
    return sum(k.dur for k in ks) / 1e3 / info["steps"] if ks and info.get("steps") else None
