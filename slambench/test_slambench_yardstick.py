"""The frozen arithmetic: K1's bytes at the two launch shapes the port
records, the atlas rows, the bound, the busy time and idle gaps of a
hand-made trace, the per-layer readers on it, and the alignment."""

import numpy as np
import pytest

from slambench import readers, trace, yardstick


def test_k1_bytes_at_the_recorded_shapes():
    rows = yardstick.atlas_rows()
    assert rows == 1896
    assert yardstick.k1_bytes((8, rows, 640)) == 78_873_600
    assert yardstick.k1_bytes((1, rows, 640)) == 10_920_960
    assert yardstick.k1_ops((8, rows, 640)) == 8 * rows * 640 * 125
    # bytes bound it: 78,873,600 B at 3.35 TB/s = 0.02354 ms
    assert yardstick.bound_ms(78_873_600, yardstick.k1_ops((8, rows, 640))) \
        == pytest.approx(78_873_600 / 3.35e12 * 1e3)


# a hand-made trace (microseconds): three kernels, two overlapping
KERNELS = [("a", 0.0, 10.0), ("fast_harris_kernel<false>(...)", 5.0, 20.0),
           ("b", 40.0, 50.0)]


def test_union_and_gaps():
    spans = [(s, e) for _, s, e in KERNELS]
    assert yardstick.union_length(spans) == 30.0
    assert yardstick.gaps(spans, 0.0, 60.0) == [(20.0, 40.0), (50.0, 60.0)]


def test_idle_gaps_are_named_by_span():
    marks = [("pass", 0.0, 60.0), ("lap:extract", 25.0, 25.0),
             ("lap:pairs", 55.0, 55.0)]
    spans = trace._spans(marks, None)
    assert spans == [("extract", 0.0, 25.0), ("pairs", 25.0, 55.0)]
    assert trace._label(spans, 30.0) == "pairs"
    live = trace._spans([("frame:3", 0.0, 9.0)], lambda i: f"f{i}")
    assert live == [("f3", 0.0, 9.0)]


def test_readers_on_a_hand_made_trace():
    tr = dict(busy_s=30e-6, window_s=60e-6, device_ops=3, k1_launches=1,
              k1_s=15e-6)
    ctx = dict(trace=tr, traced_frames=8, atlas=(1896, 640), frames=16,
               timings={"extract": 0.032}, latency_ms=[30.0, 40.0, 70.0],
               is_keyframe=[False, False, True])
    assert readers.device_idle(ctx) == pytest.approx(50.0)
    assert readers.launches_per_frame(ctx) == pytest.approx(3 / 8)
    assert readers.stage_ms(ctx, "extract") == pytest.approx(2.0)
    assert readers.stage_ms(ctx, "retrack") is None
    assert readers.frame_ms(ctx, False) == pytest.approx(35.0)
    assert readers.frame_ms(ctx, True) == pytest.approx(70.0)
    bound_s = yardstick.bound_ms(78_873_600, yardstick.k1_ops((8, 1896, 640))) / 1e3
    assert readers.k1_roofline(ctx) == pytest.approx(100 * bound_s / 15e-6)
    assert readers.k1_roofline(dict(ctx, trace=dict(tr, k1_launches=0))) is None


def test_umeyama_recovers_a_similarity():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(50, 3))
    a = 0.3
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    dst = 2.5 * src @ R.T + [1.0, -2.0, 0.5]
    Rf, tf, s = yardstick.umeyama(src, dst, with_scale=True)
    assert s == pytest.approx(2.5) and np.allclose(Rf, R) and np.allclose(tf, [1, -2, 0.5])
