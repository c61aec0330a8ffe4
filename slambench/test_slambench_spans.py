"""The readers of the program's sub-spans and host-sync count on a
hand-made context, and on one without the keys (a program that writes
only stage seconds), which gives None."""

import pytest

from slambench import run

STAGES = {"extract": 0.30, "pairs": 0.60, "map": 0.25, "refine": 0.02,
          "retrack": 0.70}
SPANS = {"pairs/match": 0.10, "pairs/ransac": 0.12, "pairs/gn": 0.30,
         "map/match": 0.05, "map/ransac": 0.02, "map/gn": 0.06,
         "retrack/match": 0.15, "retrack/ransac": 0.10, "retrack/gn": 0.40,
         "#host_syncs": 30}
NEW = ("match_ms.map", "ransac_ms.map", "gn_ms.map", "syncs_per_frame.map")


def _ctx(timings):
    return dict(timings=timings, frames=1080, trace=None, traced_frames=360,
                atlas=(1896, 640), window_frames=1440)


def test_readers_sum_their_span_over_the_stages():
    ctx = _ctx({**STAGES, **SPANS})
    read = {m: run.reader(m) for m in NEW}
    assert read["match_ms.map"](ctx) == pytest.approx(1e3 * 0.30 / 1080)
    assert read["ransac_ms.map"](ctx) == pytest.approx(1e3 * 0.24 / 1080)
    assert read["gn_ms.map"](ctx) == pytest.approx(1e3 * 0.76 / 1080)
    assert read["syncs_per_frame.map"](ctx) == pytest.approx(30 / 1080)
    # the stage metrics read the stage's own key, not its spans
    assert run.reader("pairs_ms.map")(ctx) == pytest.approx(1e3 * 0.60 / 1080)


@pytest.mark.parametrize("metric", NEW)
def test_readers_give_none_without_their_keys(metric):
    assert run.reader(metric)(_ctx(dict(STAGES))) is None
    assert run.reader(metric)(dict(_ctx({**STAGES, **SPANS}), frames=0)) is None
