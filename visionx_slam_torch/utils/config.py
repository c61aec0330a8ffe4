"""Tracking options (a copy of ``visionx_slam_tpu/utils/config.py``'s
``TrackingOptions``: same fields, same defaults; names match the reference
flags 1:1). The port reads only the fields its RGB-D offline path uses; the
rest are kept so the two dataclasses stay interchangeable."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class TrackingOptions:
    """Frontend/backend tunables; names match the reference flags 1:1.

    Reference: apps/main.cpp:21-47 and core/frontend/tracking.h:24-54.
    """

    min_matches: int = 20
    min_inliers: int = 15
    min_keyframe_inliers: int = 20
    min_parallax: float = 5.0          # pixels (mean match displacement)
    max_reproj_error: float = 2.0      # pixels, PnP RANSAC gate
    min_keyframe_gap: int = 3
    enable_culling: bool = False

    # ===== Map culling (reference: tracking.cpp:652-840) =====
    min_landmark_observations: int = 2
    min_landmarks_for_culling: int = 200
    min_keyframes_for_culling: int = 3
    max_keyframes: int = 30
    kf_min_shared_observations: int = 3
    kf_redundant_ratio: float = 0.9
    landmark_max_reproj_error: float = 5.0

    # ===== Triangulation (reference: tracking.cpp:856-929) =====
    triangulation_max_reproj_error: float = 5.0
    triangulation_min_angle_deg: float = 1.0

    # ===== Local BA (reference: core/backend/local_ba.h:12-19) =====
    enable_local_ba: bool = True
    ba_window_size: int = 5
    ba_iterations: int = 5
    ba_min_pose_observations: int = 20
    ba_min_point_observations: int = 2
    ba_huber_delta: float = 5.0
    ba_max_reproj_error: float = 5.0
    # Extension knob (not a reference flag): relative-cost convergence
    # tolerance for local BA's early exit. The reference's rule is 1e-6
    # (local_ba.cpp:244-246), which float32 GN practically never reaches —
    # the loop then always runs its full ba_iterations budget. The default
    # 1e-3 is a plateau test (stop once an iteration improves cost by
    # < 0.1%; 2-3 iterations on a healthy window, measured ATE-neutral);
    # config/reference_strict.cfg restores 1e-6.
    ba_rel_tol: float = 1e-3

    # ===== New-framework extensions (not reference flags) =====
    # Recover the metric scale of the two-frame essential initialization
    # from RGB-D depth (the reference keeps recoverPose's unit-norm t,
    # tracking.cpp:539-541, leaving its init at arbitrary scale against its
    # own metric depth landmarks). False = strict reference behavior.
    init_scale_from_depth: bool = True
    # Initialize the second frame by PnP against the first frame's
    # depth-backprojected landmarks when depth is available (tiny-baseline
    # essential estimation is ill-conditioned and leaves the reference's
    # init internally inconsistent). Falls back to the essential path when
    # too few depth points exist (monocular input). False = strict
    # reference behavior (essential init always).
    rgbd_init: bool = True
    # Apply the same depth-based scale recovery to the TrackLastFrame
    # essential fallback (the reference composes recoverPose's unit-norm
    # translation there too — SURVEY.md known quirk "scale drift risk",
    # tracking.cpp:539-541 via :315). False = strict reference behavior.
    fallback_scale_from_depth: bool = True
    # Use the current frame's depth for the PnP minimal solver (3-point
    # closed-form Procrustes instead of 6-point DLT+eigh — no batched eigh
    # on the hot path). Scoring/refinement stay 2D-reprojection-only, so
    # semantics match cv::solvePnPRansac; depth only changes which
    # hypotheses get drawn. False = strict reference behavior (2D-only
    # minimal solver, like cv::solvePnPRansac's internal EPnP).
    pnp_use_depth: bool = True
    # PnP RANSAC budget for the online frame loop. The reference asks
    # cv::solvePnPRansac for min(100, 2n) iterations (tracking.cpp:421);
    # here every kept hypothesis gets a GN polish and the previous pose
    # competes as a motion-prior IRLS hypothesis, so a smaller raw budget
    # covers the same failure modes (recovery is hypothesis-bound only
    # below ~30% inliers — tests/test_estimation.py pins both regimes).
    # ESCAPE HATCH: that calibration is from synthetic fr-class scenes; on
    # harder data where inliers drop below ~30% WHILE the motion prior is
    # also poor, raise this (config/reference_strict.cfg restores a
    # 64-hypothesis budget, and blind init always uses
    # max(64, pnp_hypotheses) regardless of this flag).
    pnp_hypotheses: int = 24
    pnp_refine_iters: int = 4
    # Associate the CURRENT frame's features with the landmarks their
    # keyframe matches already carry when the frame becomes a keyframe
    # (reprojection-gated ORB-SLAM-style association). The reference never
    # does this — its TriangulateWithLastKeyFrame only SKIPS already-linked
    # pairs (tracking.cpp:876-879), so a new keyframe's landmark links come
    # solely from fresh triangulation; in monocular mode that starves PnP
    # (measured: a healthy 245-landmark init followed by a keyframe with 1
    # linked feature and an immediate tracking collapse). False = strict
    # reference behavior; the bench's monocular configs enable it.
    link_tracked_landmarks: bool = False
    # Reject the two-frame essential initialization unless at least this
    # many matches would actually TRIANGULATE under the configured angle +
    # reprojection gates (tracking.cpp:881-929): near-pure-rotation pairs
    # can pass the recoverPose inlier gate while leaving a map too thin to
    # track against (measured: a 25-inlier pair yielding ONE landmark).
    # 0 = strict reference behavior (no viability gate).
    min_init_landmarks: int = 0
