"""Telemetry, the torch counterpart of ``repro.obs``.

``metrics``
    :class:`MetricsAccumulator`: KPIs summed on the device through a
    rollout and flushed to the host once.
``trace``
    :func:`annotate`: phase markers (``env/*``, ``wrap/*``, ``ppo/*``,
    ``eval/*``) as ``torch.profiler.record_function`` spans, a shared null
    context while disabled; :func:`trace_session` writes a perfetto trace
    (``rl_train --profile DIR``).
``guard``
    :func:`assert_one_compiled_step`: a params catalog has one signature
    and steps as one env (``rl_train`` preflight).
``sinks``
    :class:`MetricsWriter` (JSONL) + :func:`run_manifest` (git sha, torch
    and CUDA versions, backend, device) + ``BENCH_<name>.json``, in the JAX
    package's record layout.
"""
from repro_torch.obs.guard import RecompileError, assert_one_compiled_step
from repro_torch.obs.metrics import MetricsAccumulator, kpi_summary, tree_find_accumulators
from repro_torch.obs.sinks import (
    SCHEMA_VERSION,
    MetricsWriter,
    commits_behind,
    emit_json_line,
    read_jsonl,
    run_manifest,
    write_benchmark_json,
)
from repro_torch.obs.trace import (
    annotate,
    check_trace_budget,
    enable_trace_annotations,
    latest_trace,
    trace_annotations_enabled,
    trace_session,
)

__all__ = [
    "MetricsAccumulator",
    "MetricsWriter",
    "RecompileError",
    "SCHEMA_VERSION",
    "annotate",
    "assert_one_compiled_step",
    "check_trace_budget",
    "commits_behind",
    "emit_json_line",
    "enable_trace_annotations",
    "kpi_summary",
    "latest_trace",
    "read_jsonl",
    "run_manifest",
    "trace_annotations_enabled",
    "trace_session",
    "tree_find_accumulators",
    "write_benchmark_json",
]
