"""Kernels whose innermost span is one of the env's (``env/*``), per batched step."""


def read(tr, info):
    ks = tr.kernels(lambda s: s.startswith("env/"))
    return len(ks) / info["steps"] if ks and info.get("steps") else None
