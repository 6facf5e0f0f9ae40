"""The yardstick's frozen arithmetic and the trace reader, against values
worked out by hand."""
import gzip
import json

import pytest

from chipbench import trace, work

PAPER16 = {"obs_dim": 137, "hidden": [128, 128], "n_heads": 17, "n_actions": 21}


@pytest.mark.parametrize("b,p,nn,packs,want", [
    # 4 * (16384*17*12 + 3*16384 + (4*17 + 3*17 + 3))
    (16384, 17, 3, None, 13_566_440),
    # 4 * (16383*17*12 + 3*16383 + 3*(4*17 + 5*17 + 5) + 16383)
    (16383, 17, 5, 3, 13_632_552),
    (262144, 17, 3, None, 217_055_720),
])
def test_transition_bytes(b, p, nn, packs, want):
    assert work.transition_bytes(b, p, nn, packs) == want


def test_transition_ops_and_least_time():
    # 16384 * 17 * (75 + 6 * 3)
    assert work.transition_ops(16384, 17, 3) == 25_903_104
    # bandwidth-bound: 13,566,440 B at 3.35 TB/s
    assert work.transition_least_s(16384, 17, 3) == pytest.approx(13_566_440 / 3.35e12)


def test_actor_critic_flops():
    # actor: 2 * (137*128 + 128*128 + 128*357)
    assert work.act_flops(PAPER16) == 159_232
    # critic: 2 * (137*128 + 128*128 + 128*1)
    assert work.critic_flops(PAPER16) == 68_096
    # rollout forward + 4 epochs of forward and backward (3x the forward)
    assert work.train_flops_per_env_step(PAPER16, 4) == 13 * 227_328 == 2_955_264


def _trace(tmp_path, events):
    path = tmp_path / "t.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(path)


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "tid": tid, "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


def test_trace_reader(tmp_path):
    events = [
        _span(trace.WINDOW, 0, 100),
        _span("eval/rollout", 5, 90),
        _span("env/fused_transition", 10, 10),
        _span("env/observe", 30, 10),
        _span("other thread", 0, 100, tid=2),
        _launch(12, 1), _kernel("chargax_step", 20, 10, 1),      # innermost: env/fused_transition
        _launch(32, 2), _kernel("cat", 25, 10, 2),               # overlaps the first: union 20..35
        _launch(50, 3), _kernel("gemm", 60, 20, 3),              # innermost: eval/rollout
        _launch(2, 4), _kernel("early", 1, 2, 4),                # innermost: the window itself
        _kernel("outside", 150, 5, 9),                           # after the window: dropped
    ]
    tr = trace.load(_trace(tmp_path, events))
    spans = {o.name: o.span for o in tr.ops}
    assert spans == {"chargax_step": "env/fused_transition", "cat": "env/observe",
                     "gemm": "eval/rollout", "early": trace.WINDOW}
    assert tr.window_s == pytest.approx(100e-6)
    # union of [1,3], [20,35], [60,80]
    assert tr.busy_s() == pytest.approx(37e-6)
    assert len(tr.kernels(lambda s: s.startswith("env/"))) == 2
    assert [o.name for o in tr.under("eval/rollout")] == ["chargax_step", "cat", "gemm"]
    assert tr.span_wall_s("env/observe") == pytest.approx(10e-6)
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0] == ["gemm", pytest.approx(20e-6)]
    # the gaps 0..1 and 3..20 begin with only the window open, 35..60 inside
    # env/observe, 80..100 inside eval/rollout
    idle = dict((k, v) for k, v in bd["idle_gaps"])
    assert idle == {trace.WINDOW: pytest.approx(18e-6), "env/observe": pytest.approx(25e-6),
                    "eval/rollout": pytest.approx(20e-6)}


def test_innermost_prefers_the_enclosed_span_on_a_shared_start():
    spans = {"outer": [(0.0, 10.0, 1)], "inner": [(0.0, 5.0, 1)]}
    assert trace.innermost(spans, [(1.0, 1), (7.0, 1), (11.0, 1), (1.0, 2)]) == ["inner", "outer", None, None]
