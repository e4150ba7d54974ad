"""The window's arithmetic: a rate over all the work and all the time of the
window, a tail over every sample, and the device's busy time and idle gaps
from a profiler's trace, each with a stall in it."""

import json
import time

import pytest

from chipbench import trace
from chipbench.kinds import common


def test_rate_is_over_the_whole_window_with_its_stall():
    calls = []

    def step():
        calls.append(time.perf_counter())
        time.sleep(0.25 if len(calls) == 3 else 0.01)   # one step stalls
        return len(calls)

    win = common.Window("cpu")
    t_start = time.perf_counter()
    outs = win.loop(step, 0.4, False, t_start)
    assert win.seconds >= 0.4 and win.setup_s >= 0.0
    assert len(outs) == len(calls)
    # the stall is inside the window: the rate counts it, no median hides it
    rate = len(outs) / win.seconds
    assert rate < (len(outs) - 1) / (0.4 - 0.25 + 0.01)
    assert calls[-1] - calls[0] < win.seconds


def test_p95_is_over_every_sample():
    lat = [0.010] * 95 + [0.500] * 5          # 5 of 100 stalled
    assert common.p95_ms(lat) == pytest.approx(10.0)
    lat = [0.010] * 94 + [0.500] * 6
    assert common.p95_ms(lat) == pytest.approx(500.0)
    assert common.p95_ms([]) == float("inf")


class _Prof:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def test_busy_time_and_idle_gaps_from_a_trace():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 50.0, "dur": 100.0},    # overlaps a
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 1150.0, "dur": 50.0},  # 1 ms stall
        {"ph": "X", "cat": "kernel", "name": "d", "ts": 1300.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0.0, "dur": 5000.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 140.0, "dur": 1020.0},
    ]
    ops, busy, gaps = trace.read(_Prof(ev))
    assert ops["a"] == (pytest.approx(100e-6), 1) and "outer" not in ops
    assert busy == pytest.approx((150 + 50 + 100) * 1e-6)
    assert gaps[0] == ("aten::item", pytest.approx(1000e-6))
    assert gaps[1] == ("outer", pytest.approx(100e-6))


def test_readers_give_nothing_where_there_is_nothing_to_read():
    from chipbench import readers

    obs = common.Observed(kind="train", units=3, window_s=1.0, busy_s=0.8,
                          ops={"void ffn_tc<true>(x)": (0.2, 3), "void ffn_tc<false>(x)": (0.1, 3),
                               "gather_rows": (0.03, 30)},
                          least={"grouped_ffn": 0.15}, model_flops=3e14, model_s=1.0)
    assert readers.roofline(obs, "grouped_ffn", "train") == pytest.approx(50.0)
    assert readers.roofline(obs, "flash_attention", "train") is None
    assert readers.roofline(obs, "grouped_ffn", "prefill") is None
    assert readers.dispatch_ms(obs, "train") == pytest.approx(10.0)
    assert readers.idle_share(obs, "train") == pytest.approx(20.0)
    assert readers.mfu(obs, "train") == pytest.approx(100 * 3e14 / 989e12)
    assert readers.phase_ms(obs, "optimizer") is None
    assert readers.syncs(obs, "train") is None
    assert readers.latency_p95(obs, "train") is None
