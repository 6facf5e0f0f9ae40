"""The readers of the policy's, the sampler's and the clock advance's spans
on a synthetic trace: each reads the kernels of its own span only, stays
silent where that span holds none, and the env's total still counts the
sampler's kernels nested in ``env/depart_arrive``."""
import pytest

from chipbench import trace
from chipbench.harness import ROOT, reader
from chipbench.tests.test_chipbench_arithmetic import _kernel, _launch, _span, _trace

STEPS = 2
# metric -> the span it reads and the device µs the trace below puts there
OWN = {
    "policy.device_ms_per_step": ("policy/act", 40.0),
    "sampler.device_ms_per_step": ("env/sample", 7.0),
    "advance.device_ms_per_step": ("env/advance", 3.0),
}


def _step_events():
    """One window of an evaluation step: the policy, then an env step whose
    sampler runs inside ``env/depart_arrive``; one kernel launched in each
    span, its duration distinct."""
    return [
        _span(trace.WINDOW, 0, 1000),
        _span("eval/rollout", 5, 990),
        _span("policy/act", 10, 90),
        _span("env/fused_transition", 100, 100),
        _span("env/depart_arrive", 200, 200),
        _span("env/sample", 250, 50),
        _span("env/reward", 400, 100),
        _span("env/advance", 500, 50),
        _span("env/info", 550, 50),
        _launch(20, 1), _kernel("gemm", 20, 30, 1),
        _launch(60, 2), _kernel("argmax", 60, 10, 2),                  # policy/act: 40 µs
        _launch(110, 3), _kernel("chargax_step", 110, 20, 3),
        _launch(210, 4), _kernel("depart", 210, 5, 4),                 # env/depart_arrive itself
        _launch(260, 5), _kernel("multinomial_scan", 260, 7, 5),       # env/sample
        _launch(410, 6), _kernel("settle", 410, 11, 6),
        _launch(510, 7), _kernel("price_row_gather", 510, 3, 7),       # env/advance
        _launch(560, 8), _kernel("info_sum", 560, 2, 8),
        _launch(700, 9), _kernel("ep_reward_add", 700, 1, 9),          # eval/rollout itself
    ]


@pytest.mark.parametrize("metric", sorted(OWN))
def test_each_reader_reads_its_own_span_only(tmp_path, metric):
    tr = trace.load(_trace(tmp_path, _step_events()))
    span, us = OWN[metric]
    assert [o.span for o in tr.kernels(span)] and all(o.span == span for o in tr.kernels(span))
    assert reader(ROOT, metric)(tr, {"steps": STEPS}) == pytest.approx(us / 1e3 / STEPS)


@pytest.mark.parametrize("metric", sorted(OWN))
def test_each_reader_is_silent_without_kernels_in_its_span(tmp_path, metric):
    span, _ = OWN[metric]
    read = reader(ROOT, metric)
    # the span is open but launches nothing; elsewhere kernels run
    opened = [_span(trace.WINDOW, 0, 100), _span(span, 10, 10), _span("env/reward", 30, 10),
              _launch(32, 1), _kernel("settle", 35, 5, 1)]
    assert read(trace.load(_trace(tmp_path, opened)), {"steps": STEPS}) is None
    # a program without the span (the CPU, or a commit before it), and no steps
    absent = [e for e in _step_events() if e.get("name") != span]
    assert read(trace.load(_trace(tmp_path, absent)), {"steps": STEPS}) is None
    assert read(trace.load(_trace(tmp_path, _step_events())), {}) is None


def test_env_total_counts_the_sampler_nested_in_depart_arrive(tmp_path):
    tr = trace.load(_trace(tmp_path, _step_events()))
    env_kernels = {o.name for o in tr.kernels(lambda s: s.startswith("env/"))}
    assert env_kernels == {"chargax_step", "depart", "multinomial_scan", "settle", "price_row_gather", "info_sum"}
    # 20 + 5 + 7 + 11 + 3 + 2 µs of the env's, over two steps
    assert reader(ROOT, "env.device_ms_per_step")(tr, {"steps": STEPS}) == pytest.approx(48 / 1e3 / STEPS)
    assert reader(ROOT, "env.launches_per_step")(tr, {"steps": STEPS}) == 6 / STEPS
    # and the sampler's kernels are a part of that total, not beside it
    assert reader(ROOT, "sampler.device_ms_per_step")(tr, {"steps": STEPS}) < \
        reader(ROOT, "env.device_ms_per_step")(tr, {"steps": STEPS})
