"""The reduction of a profiled window, on a made-up trace."""
from __future__ import annotations

from portbench import trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_busy_idle_and_gap_names():
    events = [
        _x(trace.STEP, "user_annotation", 100, 100),     # [100, 200]
        _x(trace.STEP, "user_annotation", 200, 100),     # [200, 300]
        _x("hop_megakernel_kernel(HopParams)", "kernel", 120, 30),
        _x("hop_megakernel_kernel(HopParams)", "kernel", 140, 20),
        _x("Memcpy HtoD", "gpu_memcpy", 250, 10),
        _x("elementwise", "kernel", 50, 10),              # before window
        _x("aten::add", "cpu_op", 110, 5),                # host, ignored
    ]
    # host spans on the perf_counter clock (s); the trace is offset 1000 us
    spans = [(-0.00090, -0.00080, "push"),   # [100, 200] on the trace clock
             (-0.00080, -0.00070, "step"),   # [200, 300]
             (-0.00078, -0.00072, "fence")]  # [220, 280]
    out = trace.reduce_trace(events, spans, offset_us=1000.0)
    assert out["steps"] == 2 and abs(out["window_s"] - 200e-6) < 1e-12
    assert abs(out["busy_s"] - 50e-6) < 1e-12      # [120, 160] + [250, 260]
    assert out["kernel_count"] == 2
    assert out["by_name"]["hop_megakernel_kernel(HopParams)"][0] == 2
    gaps = dict(out["idle_gaps"])
    # [100, 120] push; [160, 250] mid 205 step; [260, 300] mid 280 fence
    assert abs(gaps["push"] - 20e-6) < 1e-12
    assert abs(gaps["step"] - 90e-6) < 1e-12
    assert abs(gaps["fence"] - 40e-6) < 1e-12
    assert out["device_ops"][0][0] == "hop_megakernel_kernel(HopParams)"


def test_union_and_gaps():
    assert trace.union([(3, 4), (0, 2), (1, 3)]) == [(0, 4)]
    assert trace.gaps([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 3), (4, 5)]
    assert trace.clip([(0, 2), (3, 9)], 1, 5) == [(1, 2), (3, 5)]
    assert trace.innermost([(0, 10, "a"), (2, 4, "b")], 3) == "b"
    assert trace.innermost([(0, 10, "a")], 11) == "outside"
