"""The reading of a device trace: busy time as a union, idle gaps named by
the benchmark's spans; and the roofline arithmetic."""

import json

import pytest

from portbench import roofline
from portbench.tracing import Spans, TraceTruncated, read_trace


def test_union_and_gaps(tmp_path):
    ev = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}
    events = [ev("fill", 900.0, 2.0),          # an edge kernel before the first marker
              ev("at::cuda::spin_kernel(long)", 1000.0, 1.0),
              ev("k1", 1010.0, 100.0), ev("k2", 1050.0, 100.0),      # overlap: 1010-1150
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1400.0, "dur": 50.0},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1500.0,
               "dur": 400.0},
              ev("at::cuda::spin_kernel(long)", 2000.0, 1.0),
              ev("add", 2100.0, 2.0)]             # and one after the last
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    spans = Spans()
    host0 = 5.0          # host clock of the first marker's launch
    spans.add("pass", host0 + 0.0001, host0 + 0.0005)
    spans.add("fetch", host0 + 0.0005, host0 + 0.0010)
    got = read_trace(str(path), (host0, host0 + 0.001), spans)
    assert got["window_s"] == pytest.approx(1000e-6)
    assert got["busy_s"] == pytest.approx((140 + 50) * 1e-6)
    assert [g[1] for g in got["idle_gaps"]] == pytest.approx([550e-6, 250e-6, 10e-6])
    assert [g[0] for g in got["idle_gaps"]] == ["fetch", "pass", "between spans"]
    assert got["device_ops"][0][0] in ("k1", "k2")


def test_roofline_counts():
    nbytes, ops = roofline.pair_min_work(32, 400, 300000)
    assert ops == 25 * 32 * 400 * 300000
    t, by = roofline.bound(nbytes, ops)
    assert by == "operations" and t == pytest.approx(ops / 3.35e13)
    assert roofline.share_pct((nbytes, ops), 2 * t) == pytest.approx(50.0)
    nbytes, ops = roofline.center_work(32, 99000, True)
    assert roofline.bound(nbytes, ops)[1] == "bytes"
    assert roofline.RDF_PAIR_OPS == 30 and roofline.TRICLINIC_PAIR_MIN_OPS == 27


def test_a_trace_that_lost_its_end_marker_is_refused(tmp_path):
    """Kernels a trace lost would read as idle time: such a trace is not read."""
    ev = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [ev("at::cuda::spin_kernel(long)", 1000.0, 1.0),
                                                ev("k1", 1100.0, 300.0)]}))
    with pytest.raises(TraceTruncated):
        read_trace(str(path), (5.0, 5.0008), Spans())
