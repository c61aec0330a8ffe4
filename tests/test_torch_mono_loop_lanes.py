"""Folded lanes of the port's monocular offline pipeline with the loop
closure and the landmark merge on (``mono_loop_pairs=12``,
``mono_loop_merge=True``), on the JAX package's two-loop fixture (48
frames of 640x480, scene seed 13, a 24-frame loop; ``kf_capacity`` 16 and
tests/test_offline_mono.py's mono budget): the sequence and its reverse as
two lanes, whose lane 0 equals a single run of the sequence bit for bit
(poses, tracked flags, keyframe and landmark tables, loop counts), as
tests/test_offline_mono.py::test_mono_folded_loop_closure_matches_single
asks of the JAX package within 1e-4. Candidates and budgets stay within a
lane, and the similarities add in a fixed order, so nothing of lane 1
reaches lane 0. The frames go through ``torch_parity.OrbMemo`` (each
extracted once).
"""

import numpy as np
import torch

from visionx_slam_torch.tracking import offline_pipeline as TOP
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import OrbMemo, cameras, sequence, to_np

KW = dict(monocular=True, kf_capacity=16, mono_pair_hypotheses=64,
          mono_lo_starts=2, mono_sample_bias=64.0, mono_score_top_k=32,
          mono_loop_pairs=12, mono_loop_merge=True)


def test_folded_loop_merge_lane0_equals_single_run():
    grays, _, _ = sequence(48, 13, 24)
    zero = np.zeros(grays.shape, np.float32)
    _, tc = cameras()
    g2 = np.stack([grays, grays[::-1].copy()])
    st1, st2 = {}, {}
    with OrbMemo(TOP):
        ms1, o1 = TOP.run_offline_pipeline(tc, grays, zero, TrackingOptions(),
                                           device="cpu", stats=st1, **KW)
        ms2, o2 = TOP.run_offline_pipeline_batched(tc, g2, np.zeros(g2.shape, np.float32),
                                                   TrackingOptions(), device="cpu",
                                                   stats=st2, **KW)
    assert torch.equal(o2.pose[0], o1.pose) and torch.equal(o2.tracked[0], o1.tracked)
    for f in ("kf_q", "kf_t", "kf_id", "kf_feat_lm", "lm_alive", "lm_obs", "next_lm"):
        assert torch.equal(getattr(ms2, f)[0], getattr(ms1, f)), f
    # rows past the lane's landmarks hold the next lane's (split_merged_lanes)
    n = int(ms1.next_lm)
    assert torch.equal(ms2.lm_pos[0][:, :n], ms1.lm_pos[:, :n])
    # a lane counts the landmarks it created, a single run its live ones
    # (as in the JAX package; they differ once the merge kills landmarks)
    assert int(o2.n_landmarks[0]) == n and int(o1.n_landmarks) == int(ms1.lm_alive.sum())
    assert st2["loop_verified_frames_per_lane"][0] == st1["loop_verified_frames"] > 0
    assert st1["loop_pairs_verified"] > 0 and st2["loop_pairs_verified"] > st1["loop_pairs_verified"]
    assert to_np(o2.tracked[1]).mean() >= 0.9
