"""Configuration (a copy of ``visionx_slam_tpu/utils/config.py``: the same
fields, defaults and order, so the flag surface generated from them is the
same, plus the port's ``SystemConfig.device``), with the reference's
config-file overlay rules (apps/main.cpp:61-103):

- config files are ``key=value`` lines, ``#`` starts a comment, whitespace
  is trimmed;
- a config value is applied only where the command line left the flag at
  its default ("CLI wins");
- unknown keys produce a warning, not an error.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass, field, fields
from typing import Any

log = logging.getLogger("vxs.config")


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
    # The port's widening (not a reference flag, nor the JAX package's):
    # after the PnP against the last keyframe, match the landmarks of the
    # ring's ba_window_size - 1 keyframes before it by projection and refine
    # the pose on both (tracking/local_map.py). The reference tracks against
    # the last keyframe alone, so each keyframe's error is carried on like
    # odometry. False = the reference's tracking, bit for bit.
    track_local_map: bool = False


@dataclass
class SystemConfig:
    """Full runner config = dataset/runner flags + TrackingOptions.

    Runner flag names match apps/main.cpp:15-19. ``viewer_*`` flags are
    accepted for CLI compatibility but map to the trajectory-dump viewer
    replacement (SURVEY.md L8): there is no GL window.
    """

    config: str = ""
    dataset_dir: str = "../dataset/tum_rgbd"
    sequence: str = "rgbd_dataset_freiburg1_desk"
    viewer_thread: bool = False
    viewer_loop_ms: int = 10

    # --- new-framework extensions (not in the reference) ---
    output_dir: str = "output"          # trajectory + metrics destination
    max_frames: int = -1                # -1 = whole sequence
    # "jax" names the on-device ORB, as in the JAX package and its config
    # files ("torch" is accepted as the same thing); "opencv" is the host oracle
    extractor: str = "jax"
    loader: str = "native"              # "native" (C++ prefetch pipeline) | "python"
    run_global_ba: bool = False         # full-map Schur BA after the sequence
    global_ba_iterations: int = 10
    # resume a run from a map snapshot (map_snapshot.npz); the restored map
    # becomes the initial state and tracking continues in TRACKING_GOOD
    # against its newest keyframe (SURVEY.md §5.4 mandated addition)
    resume_from: str = ""
    # "scan": the online per-frame tracker over pre-extracted chunks (fast
    #         path, reference state-machine semantics);
    # "offline": batched frame-parallel mapping (highest throughput; RGB-D
    #         by default, set `monocular` for the essential + scale-chain
    #         variant — see tracking/offline_pipeline.py);
    # "host": per-frame host state machine (reference-parity/debug path)
    pipeline: str = "host"
    # monocular offline mode (BASELINE config 2 on the fast path): depth
    # input is ignored; poses/landmarks live in the VO scale frame
    monocular: bool = False
    # observability (SURVEY.md §5.1/§5.2): a torch.profiler trace of the run
    # is written into profile_dir; debug_nans raises on the first chunk (or
    # frame) whose poses are not finite
    profile_dir: str = ""
    debug_nans: bool = False
    n_features: int = 1000              # reference: orb_extractor.h:11
    # build the ORB pyramid (resize/pack) in f32 instead of bf16 — the
    # pre-optimization numeric path, pinned by the strict fidelity config
    # (its 5% ATE band is sensitive to resize rounding; the default bf16
    # build is validated statistically and on the default-config ATE)
    orb_resize_f32: bool = False
    metrics_jsonl: bool = True          # per-frame structured metrics
    kf_capacity: int = 64               # keyframe ring slots (scan and host paths)
    # viewer-replacement sinks (SURVEY.md L8): landmark cloud + keyframe
    # centers as PLY next to the npz snapshot; plot via cli.plot
    export_ply: bool = True
    # dump the viewer's per-frame feature-overlay image (viewer.cpp:106-141)
    # for every Nth frame of the run into output_dir/overlays/ (0 = off) —
    # the run-level debugging artifact the live GL panel provided
    dump_overlays: int = 0
    # the port's one added field: where the tensors live. "cuda" raises
    # where no card is there; the tests ask for "cpu"
    device: str = "cuda"

    tracking: TrackingOptions = field(default_factory=TrackingOptions)


_BOOL_TRUE = {"true", "1", "yes", "on"}
_BOOL_FALSE = {"false", "0", "no", "off"}


def _coerce(value: str, typ: type) -> Any:
    if typ is bool:
        v = value.strip().lower()
        if v in _BOOL_TRUE:
            return True
        if v in _BOOL_FALSE:
            return False
        raise ValueError(f"not a boolean: {value!r}")
    return typ(value)


def parse_config_file(path: str) -> dict[str, str]:
    """Parse a ``key=value`` config file (reference: apps/main.cpp:61-90)."""
    kv: dict[str, str] = {}
    try:
        with open(path, "r") as fin:
            for line in fin:
                hash_pos = line.find("#")
                if hash_pos != -1:
                    line = line[:hash_pos]
                line = line.strip()
                if not line:
                    continue
                eq = line.find("=")
                if eq == -1:
                    continue
                key = line[:eq].strip()
                value = line[eq + 1 :].strip()
                if key:
                    kv[key] = value
    except OSError:
        log.warning("Failed to open config file: %s", path)
    return kv


def _flat_field_map(cfg: SystemConfig) -> dict[str, tuple[Any, str, type]]:
    """Map flag-name -> (owner object, attr, type) over SystemConfig+TrackingOptions."""
    out: dict[str, tuple[Any, str, type]] = {}
    for f in fields(cfg):
        if f.name == "tracking":
            continue
        out[f.name] = (cfg, f.name, f.type if isinstance(f.type, type) else type(getattr(cfg, f.name)))
    for f in fields(cfg.tracking):
        out[f.name] = (cfg.tracking, f.name, type(getattr(cfg.tracking, f.name)))
    return out


def apply_config_if_default(
    cfg: SystemConfig, kv: dict[str, str], cli_set: set[str]
) -> SystemConfig:
    """Overlay config-file values onto ``cfg`` where the CLI left the default.

    ``cli_set`` holds flag names the user explicitly passed on the command
    line; those win over the config file (reference: apps/main.cpp:92-103).
    Unknown keys warn (apps/main.cpp:96).
    """
    fmap = _flat_field_map(cfg)
    for key, value in kv.items():
        if key not in fmap:
            log.warning("Unknown config key: %s", key)
            continue
        if key in cli_set:
            continue  # CLI wins
        owner, attr, typ = fmap[key]
        try:
            setattr(owner, attr, _coerce(value, type(getattr(owner, attr))))
        except ValueError as e:
            log.warning("Bad value for %s: %s", key, e)
    return cfg


def config_to_dict(cfg: SystemConfig) -> dict[str, Any]:
    d = dataclasses.asdict(cfg)
    tr = d.pop("tracking")
    d.update(tr)
    return d
