"""The scan's profiling knob against the JAX package's: ``stage_limit``
0, 1, 3 and 4 on 8 frames (seed 7, 8 keyframe slots, BA window 4), outputs
equal. The frames go through ``torch_parity.OrbMemo``, which extracts each
frame once for all the runs of the file. ``orb_extract``'s knobs
(``profile_stage``, ``use_kernel``) are tested in tests/test_torch_orb.py,
beside the extraction they cut short."""

import jax
import numpy as np
import pytest

from visionx_slam_tpu.tracking.scan_pipeline import run_scan_pipeline as jax_run
from visionx_slam_tpu.utils.config import TrackingOptions as JOpts

from visionx_slam_torch.tracking import scan_pipeline as TSP
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import OrbMemo, cameras, sequence, to_np


@pytest.fixture(scope="module")
def memo():
    with OrbMemo(TSP) as m:
        yield m


@pytest.mark.parametrize("stage_limit", [0, 1, 3, 4])
def test_scan_stage_limit_matches_jax(stage_limit, memo):
    grays, depths, _ = sequence(8, 7)
    jc, tc = cameras()
    _, oj = jax_run(jc, grays, depths, JOpts(ba_window_size=4), kf_capacity=8,
                    stage_limit=stage_limit)
    jax.block_until_ready(oj)
    stats = {}
    st, ot = TSP.run_scan_pipeline(tc, grays, depths,
                                   TrackingOptions(ba_window_size=4),
                                   kf_capacity=8, stage_limit=stage_limit,
                                   device="cpu", stats=stats)
    for f in ("n_matches", "n_inliers", "tracked", "state", "is_keyframe",
              "n_keyframes", "n_landmarks"):
        np.testing.assert_array_equal(to_np(getattr(ot, f)),
                                      np.asarray(getattr(oj, f)), err_msg=f)
    np.testing.assert_allclose(to_np(ot.pose), np.asarray(oj.pose), atol=1e-6)
    # no map growth, the state machine untouched
    assert st.tstate == TSP.INIT and st.kf_cursor == 0
    if stage_limit != 1:
        # the step reads nothing: the run's one read is the image statistics
        assert stats["host_syncs"] == 1


def test_scan_stage_limit_rejects_other_values():
    _, tc = cameras()
    with pytest.raises(ValueError):
        TSP.build_scan_step(tc, TrackingOptions(), (640, 480), stage_limit=5)
