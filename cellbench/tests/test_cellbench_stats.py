"""The end-to-end statistics: a rate over the whole window, and the trace
reduction."""

import pytest

from harness import window_rate


def test_the_rate_is_over_the_whole_window():
    # 100 steps of 256 rows launched in 19.9 s, the last done at 20.4 s
    assert window_rate(100 * 256, 0.0, 20.4) == pytest.approx(25600 / 20.4)
    with pytest.raises(ValueError):
        window_rate(1, 2.0, 2.0)


def test_the_trace_reduction_by_hand():
    from harness import reduce_trace

    def x(name, cat, ts, dur, tid=1):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}

    events = [x("cellbench.window", "user_annotation", 0, 100),
              x("k1", "kernel", 10, 10, 7), x("k2", "kernel", 15, 15, 7),
              x("k1", "kernel", 50, 10, 7), x("k3", "kernel", 95, 20, 7),
              x("cellbench.step", "user_annotation", 0, 40),
              x("cellbench.next", "user_annotation", 40, 60),
              x("cellbench.batch_search", "user_annotation", 0, 100, tid=2),
              x("cudaLaunchKernel", "cuda_runtime", 5, 1), x("aten::mm", "cpu_op", 62, 3)]
    r = reduce_trace(events)
    assert r["window_s"] == pytest.approx(100e-6)
    # busy: 10-30, 50-60 and 95-100 (the last kernel cut at the window)
    assert r["busy_s"] == pytest.approx(35e-6)
    assert dict(r["device_ops"]) == pytest.approx({"k1": 20e-6, "k2": 15e-6, "k3": 5e-6})
    assert dict(r["idle_gaps"]) == pytest.approx({"cellbench.step / python": 30e-6,
                                                  "cellbench.next / python": 35e-6})


def test_gaps_of_a_thread_with_no_span_take_the_longest_span_on_any_thread():
    from harness import reduce_trace

    def x(name, cat, ts, dur, tid=1):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}

    # the launching thread (9) has no span: the longest benchmark span that
    # covers a gap on any thread labels it
    events = [x("cellbench.window", "user_annotation", 0, 100), x("k", "kernel", 50, 50, 7),
              x("cudaLaunchKernel", "cuda_runtime", 45, 1, tid=9),
              x("cellbench.step", "user_annotation", 0, 60, tid=1),
              x("cellbench.next", "user_annotation", 5, 2, tid=2)]
    r = reduce_trace(events)
    assert dict(r["idle_gaps"]) == pytest.approx({"cellbench.step / python": 50e-6})
