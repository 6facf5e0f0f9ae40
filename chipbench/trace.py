"""Reading a traced window: the profiler's chrome trace reduced to host
spans, device operations (each in the innermost host span that launched
it), the device's busy time and its idle gaps.

The span and launch matching follows the repository's smoke script
(``chip_smoke.read_trace``): a device operation's host launch is the
runtime event with the same correlation id, and its span is the innermost
``record_function`` span open on the launching thread at that moment.  The
innermost span is found by one sweep over each thread's events, not by a
search per operation, so a window of 10^5 launches reads in seconds.
"""
from __future__ import annotations

import bisect
import dataclasses
import gzip
import json

from chipbench.work import PEAK_FP32_FLOP_PER_S, transition_least_s

WINDOW = "chipbench/window"
_DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
_DEVICE_CATS = _DEVICE_OPS + ("gpu_user_annotation",)


@dataclasses.dataclass
class Op:
    """One device operation: its name, device start and duration (µs), and
    the innermost host span open at its launch (None outside every span)."""

    name: str
    ts: float
    dur: float
    cat: str
    span: str | None = None
    launch_ts: float | None = None
    tid: int | None = None


@dataclasses.dataclass
class Trace:
    spans: dict[str, list[tuple[float, float, int]]]  # host spans (start, end, tid), µs
    ops: list[Op]  # device operations inside the window
    window: tuple[float, float]  # the WINDOW span, µs

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def span_calls(self, name: str) -> list[tuple[float, float]]:
        lo, hi = self.window
        return [(s, e) for s, e, _ in self.spans.get(name, []) if lo <= s <= hi]

    def span_wall_s(self, name: str) -> float:
        """Host wall seconds inside the calls of span ``name`` in the window."""
        return sum(e - s for s, e in self.span_calls(name)) / 1e6

    def kernels(self, in_span=None) -> list[Op]:
        """Kernels (no copies or fills) whose innermost span passes ``in_span``
        (a name, or a predicate on it); all kernels when None."""
        ks = [o for o in self.ops if o.cat == "kernel"]
        if in_span is None:
            return ks
        test = in_span if callable(in_span) else (lambda s: s == in_span)
        return [o for o in ks if o.span is not None and test(o.span)]

    def under(self, name: str) -> list[Op]:
        """Kernels launched while span ``name`` was open, at any depth."""
        calls = sorted(self.span_calls(name))
        starts = [s for s, _ in calls]
        out = []
        for o in self.kernels():
            if o.launch_ts is None:
                continue
            i = bisect.bisect_right(starts, o.launch_ts) - 1
            if i >= 0 and o.launch_ts <= calls[i][1]:
                out.append(o)
        return out

    def busy_s(self) -> float:
        """Seconds in which some device operation ran, inside the window."""
        return sum(hi - lo for lo, hi in busy_intervals(self.ops, *self.window)) / 1e6


def busy_intervals(ops: list[Op], lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of the operations' device intervals, clipped to [lo, hi]."""
    ivs = sorted((max(o.ts, lo), min(o.ts + o.dur, hi)) for o in ops if o.ts + o.dur > lo and o.ts < hi)
    out: list[list[float]] = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def innermost(spans: dict[str, list[tuple[float, float, int]]], points: list[tuple[float, int]]) -> list[str | None]:
    """For each (time, thread) point, the innermost span open on that thread
    at that time (the one that started last), by one sweep per thread."""
    by_tid: dict[int, list[tuple[float, float, str]]] = {}
    for name, ivs in spans.items():
        for s, e, tid in ivs:
            by_tid.setdefault(tid, []).append((s, e, name))
    out: list[str | None] = [None] * len(points)
    order = sorted(range(len(points)), key=lambda i: points[i][0])
    pending: dict[int, list[int]] = {}
    for i in order:
        pending.setdefault(points[i][1], []).append(i)
    for tid, idxs in pending.items():
        # by start, the enclosing span first where two start together
        ivs = sorted(by_tid.get(tid, []), key=lambda iv: (iv[0], -iv[1]))
        stack: list[tuple[float, str]] = []  # (end, name), innermost last
        j = 0
        for i in idxs:
            t = points[i][0]
            while j < len(ivs) and ivs[j][0] <= t:
                s, e, name = ivs[j]
                while stack and stack[-1][0] < s:
                    stack.pop()
                stack.append((e, name))
                j += 1
            # spans nest, so those that ended before t are the top of the stack
            while stack and stack[-1][0] < t:
                stack.pop()
            out[i] = stack[-1][1] if stack else None
    return out


def load(path: str) -> Trace:
    """A gzipped or plain chrome trace, reduced to the window's spans and ops."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    spans: dict[str, list[tuple[float, float, int]]] = {}
    launches: dict[int, dict] = {}
    raw = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        if cat == "user_annotation":
            spans.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"]))
        elif cat in _DEVICE_OPS:
            raw.append(e)
        elif cat not in _DEVICE_CATS and "correlation" in args:
            launches[args["correlation"]] = e
    if WINDOW not in spans:
        raise ValueError(f"the trace has no {WINDOW!r} span")
    (w0, w1, _), = spans[WINDOW]
    ops = []
    for e in raw:
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if ts + dur < w0 or ts > w1:
            continue
        launch = launches.get((e.get("args") or {}).get("correlation"))
        ops.append(Op(e["name"], ts, dur, e["cat"],
                      launch_ts=None if launch is None else float(launch["ts"]),
                      tid=None if launch is None else launch["tid"]))
    points = [(o.launch_ts, o.tid) for o in ops if o.launch_ts is not None]
    named = iter(innermost(spans, points))
    for o in ops:
        if o.launch_ts is not None:
            o.span = next(named)
    return Trace(spans, ops, (w0, w1))


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by the
    host span open when each gap began (the window span where none other)."""
    by_op: dict[str, float] = {}
    for o in tr.ops:
        by_op[o.name[:120]] = by_op.get(o.name[:120], 0.0) + o.dur / 1e6
    busy = busy_intervals(tr.ops, *tr.window)
    gaps, prev = [], tr.window[0]
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if tr.window[1] > prev:
        gaps.append((prev, tr.window[1]))
    main = tr.spans[WINDOW][0][2]
    names = innermost(tr.spans, [(s, main) for s, _ in gaps])
    by_gap: dict[str, float] = {}
    for (s, e), name in zip(gaps, names):
        key = name or "(outside the window)"
        by_gap[key] = by_gap.get(key, 0.0) + (e - s) / 1e6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_gap)}


# Readers that more than one per-layer metric shares; each metric's file
# under ``metrics/`` re-exports one as its ``read``.
def idle_share(tr: Trace, info: dict) -> float | None:
    """1 - the union of the device operations' intervals over the traced window."""
    if not tr.ops:
        return None
    return 1.0 - tr.busy_s() / tr.window_s


def mfu(tr: Trace, info: dict) -> float | None:
    """The actor-critic's model FLOPs over the traced window (counted by
    ``chipbench.work`` from the hidden sizes and rows), as a share of the
    window at the card's published fp32 peak, in %."""
    if not tr.kernels() or not info.get("model_flops"):
        return None
    return 100.0 * info["model_flops"] / (tr.window_s * PEAK_FP32_FLOP_PER_S)


def transition_roofline(tr: Trace, info: dict) -> float | None:
    """The fused transition's least time on the card (``chipbench.work``, at
    the cell's B, P, Nn and packs) over the device time of the kernels whose
    innermost span is ``env/fused_transition``, per step, in %."""
    ks = tr.kernels("env/fused_transition")
    if not ks or not info.get("steps"):
        return None
    per_step_s = sum(k.dur for k in ks) / 1e6 / info["steps"]
    return 100.0 * transition_least_s(info["b"], info["p"], info["nn"], info["packs"]) / per_step_s
