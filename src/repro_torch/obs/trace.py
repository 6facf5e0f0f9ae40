"""Trace annotations: named phases for profiles, close to free when disabled.

The torch counterpart of ``repro.obs.trace``.  :func:`annotate` marks a
region with ``torch.profiler.record_function``, which opens a span on the
host thread and, under a profiler with the CUDA activity, a span over the
device work launched inside it.  Annotations are **disabled by default**,
and then :func:`annotate` returns one shared null context: no generator, no
call into the profiler.  (``record_function`` costs several microseconds per
``with`` even when no profiler runs; an evaluation step crosses 9 phases, a
PPO rollout step 11.)

Enable them with :func:`enable_trace_annotations` or ``REPRO_TRACE=1``, or
implicitly with :func:`trace_session`, which runs ``torch.profiler`` and
writes a perfetto-viewable ``*.trace.json.gz`` (open at
https://ui.perfetto.dev).  ``rl_train --profile DIR`` is the CLI surface.

Phase names (the JAX package's, but for those marked *port*, which have no
JAX counterpart):

=========================  ==================================================
``env/decode``              action decoding (direct / delta modes)
``env/fused_transition``    request -> allocate -> deliver in the fused kernel
``env/apply_actions``       request: the constrained currents
``env/allocate``            Eq. 5 node-budget allocation (staged route; a
                            coupled fleet's per-station allocation too)
``env/charge_cars``         battery/car energy integration (staged route)
``env/depart_arrive``       arrival draws, departures, arrivals, rejections
``env/sample``              *port*: the sampler's arrival draws, inside
                            ``env/depart_arrive`` (none for injected draws)
``env/reward``              Eq. 2 revenue + penalty terms
``env/advance``             *port*: the clock, the midnight price-row reload
                            and ``done``
``env/info``                *port*: the step's ``info`` dict
``env/observe``             observation build
``policy/act``              *port*: the policy's forward and its action
                            (evaluation and the PPO rollout)
``fleet/feeder``            *port*: a grid-coupled fleet's shared feeder,
                            between the stations' allocation and deliver
``wrap/<Wrapper>``          each wrapper layer's step (AutoReset, Log, Fleet)
``ppo/rollout``             the rollout loop
``ppo/gae``                 advantage estimation
``ppo/update``              minibatch epochs
``eval/rollout``            evaluation episodes
``eval/serve``              one batched serving step
=========================  ==================================================
"""
from __future__ import annotations

import contextlib
import glob
import os
import socket
import time
from typing import Iterator

import torch

_enabled: bool = os.environ.get("REPRO_TRACE", "0").lower() in ("1", "true", "yes")

# what annotate returns while disabled: one reusable, reentrant no-op
_NULL = contextlib.nullcontext()


def trace_annotations_enabled() -> bool:
    """Whether :func:`annotate` currently opens profiler spans."""
    return _enabled


def enable_trace_annotations(on: bool = True) -> bool:
    """Toggle annotations globally; returns the previous setting."""
    global _enabled
    prev, _enabled = _enabled, bool(on)
    return prev


def annotate(name: str) -> contextlib.AbstractContextManager:
    """Mark a phase: ``with annotate("env/charge_cars"): ...``.

    Enabled, a ``torch.profiler.record_function(name)`` span.  Disabled (the
    default), the shared null context: nothing is recorded or called.
    """
    if not _enabled:
        return _NULL
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace_session(
    log_dir: str,
    enable_annotations: bool = True,
    python_tracer: bool = False,
) -> Iterator[str]:
    """Profile a region: annotations on, ``torch.profiler`` recording the
    host and, where a card is present, the device.  Yields ``log_dir``; on
    exit the trace is written to
    ``<log_dir>/<host>.<pid>.<ms>.trace.json.gz`` and the annotation toggle
    restored.  Find the trace with :func:`latest_trace`.

    Keep the traced region SMALL (one representative update, a handful of
    env steps): the profiler records every op and kernel.  ``rl_train
    --profile`` therefore traces a one-update probe, not the real run.

    ``python_tracer=True`` records Python stacks with every op
    (``with_stack``), much more data; only for hunting host overhead.
    """
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities, record_shapes=False, with_stack=python_tracer
    )
    prof.start()
    prev = enable_trace_annotations(enable_annotations)
    try:
        yield log_dir
    finally:
        prof.stop()
        enable_trace_annotations(prev)
        name = f"{socket.gethostname()}.{os.getpid()}.{int(time.time() * 1000)}.trace.json.gz"
        prof.export_chrome_trace(os.path.join(log_dir, name))


def latest_trace(log_dir: str) -> str | None:
    """Newest perfetto trace file under ``log_dir`` (None if no trace)."""
    paths = glob.glob(
        os.path.join(log_dir, "**", "*.trace.json.gz"), recursive=True
    )
    return max(paths, key=os.path.getmtime) if paths else None


def trace_bytes(log_dir: str) -> int:
    """Total size of all profiler output under ``log_dir``."""
    total = 0
    for root, _, files in os.walk(log_dir):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    return total


def check_trace_budget(log_dir: str, max_kb: int = 8192, verbose: bool = False) -> int:
    """Artifact-size guard: profiler output must stay shippable.

    Raises ``RuntimeError`` if the trace directory exceeds ``max_kb``;
    returns the total size in bytes.
    """
    total = trace_bytes(log_dir)
    if verbose:
        print(f"[obs] trace artifacts under {log_dir}: {total/1024:.1f} KB "
              f"(budget {max_kb} KB)")
    if total > max_kb * 1024:
        raise RuntimeError(
            f"trace output in {log_dir} is {total/1024:.0f} KB, over the "
            f"{max_kb} KB artifact budget — lower the traced region size "
            "(fewer updates/steps under trace_session)"
        )
    return total
