"""Offline SLAM over whole sequences as batched stages (the counterpart of
``visionx_slam_tpu/tracking/offline_pipeline.py``).

Stages, as in the JAX package:

1. ORB over all frames, in chunks of ``extract_chunk`` frames (K1 runs on
   the whole chunk's atlases at once);
2. consecutive-pair Hamming matching and 3. the relative pose, batched over
   chunks of ``pair_chunk`` pairs: RGB-D PnP RANSAC, or (``monocular``)
   essential-matrix RANSAC and two-view triangulation, whose unit-baseline
   scales a chain of shared-feature depth ratios ties together (and, with
   ``mono_loop_pairs``, revisits re-anchor: ``_scale_loop_correction``);
4. absolute poses by a log-step, segmented prefix composition over SE(3);
5. the keyframe policy (a scalar recurrence, run on the host);
6. the keyframe chain (direct keyframe-pair PnP; the VO chain in mono),
   ``build_keyframe_map`` and its observation links (mono with
   ``mono_loop_merge``: revisited landmarks merged, ``_close_loops``);
7. one Gauss-Newton pass of ``global_ba`` (after the loop merge, a wide
   pass first);
8. a batched re-track of every frame against its keyframe's landmarks (in
   mono, also the following keyframe's, with DLT hypotheses).

**Folded lanes** (``lanes=B``): the input is B sequences of T_lane frames
concatenated along the frame axis, and every stage runs over the folded
axis. Lanes stay apart by construction: pairs across a lane boundary never
track, the prefix compositions reset at lane starts, each lane keeps its
own last ``kf_capacity`` keyframes, and the refine is one ``global_ba``
gauge-grouped per lane. RANSAC draws depend only on the stage's seed and
the index within the lane (each stage draws the uniforms of one lane and
every lane gathers its rows), so lane b draws what a single run of its
frames would draw.

A failed pair freezes its relative pose at identity (in mono it inherits
its predecessor's). Randomness comes from ``torch.Generator``s seeded per
stage (29, 31, 37 — the JAX package's key seeds); the bits differ from
``jax.random``'s, so results agree with the JAX package statistically, not
bit for bit. The loop closure draws nothing.

The loop closure's similarities are exact (integer dot products in
float64, ``_block_similarity``), its other float sums (rotation traces, the
5-frame smoothing) add in a fixed order by elementwise ops (``_tree_sum``,
``_box5``), and its scatters that may meet one target twice
keep the last write in flat order explicitly (``_last_occurrence``), so a
run repeats bit for bit on the card and a folded lane equals its single
run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models import matching
from ..models.estimation import (
    _normalize_px,
    essential_ransac,
    nanmedian,
    pnp_ransac,
    triangulate_dlt,
)
from ..models.global_ba import GlobalBAOptions, global_ba
from ..models.orb_torch import orb_extract
from ..ops.camera import CameraParams, backproject, project_pinhole
from ..ops.index import stable_argsort, take_rows
from ..ops.se3 import (
    Pose,
    identity_pose,
    matrix_to_quat,
    quat_to_matrix,
    se3_apply,
    se3_compose,
    se3_inverse,
    se3_matrix,
)
from ..utils.config import TrackingOptions
from ..utils.logging import StageClock, count_sync
from . import mapstate as msl
from . import stages
from .mapstate import FREE, MapState, PairLinks


class OfflineOut(NamedTuple):
    pose: torch.Tensor         # [T,4,4] T_cw
    tracked: torch.Tensor      # [T] bool
    n_matches: torch.Tensor    # [T] int32 (vs previous frame; 0 for frame 0)
    n_inliers: torch.Tensor    # [T] int32
    parallax: torch.Tensor     # [T] float32 (vs previous frame)
    is_keyframe: torch.Tensor  # [T] bool
    n_keyframes: torch.Tensor  # [] int32 ([B] per lane when folded)
    n_landmarks: torch.Tensor  # [] int32 ([B] per lane when folded)


def _chunked(fn, chunk: int, *args, lanes: int = 1):
    """``fn(*args)`` on batched tensors, in chunks of the leading axis
    (bounds the live [chunk, N, N] distance matrices); outputs are
    concatenated along the leading axis.

    ``lanes=B``: the rows are B folded lanes, either frames (B x L rows)
    or consecutive pairs (B x L - 1 rows: each lane's L - 1 pairs, then the
    pair across to the next lane). Each lane is chunked from its own first
    row, so its rows meet the batches of a single run of the lane (batched
    decompositions and products round by their batch: a lane sharing a
    chunk with the next one differed from its single run on the card); the
    pairs across lanes go together in one more call."""
    M = args[0].shape[0]
    if lanes > 1:
        pairs = M % lanes != 0
        L = (M + 1) // lanes if pairs else M // lanes
        n = L - 1 if pairs else L
        outs = [_chunked(fn, chunk, *(a[b * L:b * L + n] for a in args))
                for b in range(lanes)]
        if not pairs:
            return tuple(torch.cat(parts) for parts in zip(*outs))
        across = torch.arange(1, lanes, device=args[0].device) * L - 1
        cross = fn(*(a[across] for a in args))
        # [B, L-1] lane rows beside [B, 1] pairs across (the last lane has
        # none: a copy pads its slot, cut off at M)
        return tuple(torch.cat([torch.stack(parts[:-1]),
                                torch.cat([parts[-1], parts[-1][:1]])[:, None]], 1)
                     .flatten(0, 1)[:M] for parts in zip(*outs, cross))
    if chunk <= 0 or M <= chunk:
        return fn(*args)
    outs = [fn(*(a[i:i + chunk] for a in args)) for i in range(0, M, chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _segmented_compose_scan(q: torch.Tensor, t: torch.Tensor,
                            flag: torch.Tensor) -> Pose:
    """Inclusive prefix composition by log-step doubling with segment
    resets: prefix[i] = value[i] where ``flag[i]`` (a segment start, whose
    value is its own anchor), else value[i] ∘ prefix[i-1]. The flagged
    combine is associative (the segmented-scan construction of the JAX
    package's ``associative_scan``); with no flag after element 0 it is
    the plain composition."""
    n = q.shape[0]
    d = 1
    while d < n:
        c = se3_compose(Pose(q[d:], t[d:]), Pose(q[:-d], t[:-d]))
        f = flag[d:, None]
        q = torch.cat([q[:d], torch.where(f, q[d:], c.q)])
        t = torch.cat([t[:d], torch.where(f, t[d:], c.t)])
        flag = torch.cat([flag[:d], flag[d:] | flag[:-d]])
        d *= 2
    return Pose(q, t)


def _normalized(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)


def _keyframe_policy(opts: TrackingOptions, n_inl, parallax, ok,
                     lane_start=None) -> np.ndarray:
    """The reference keyframe policy (tracking.cpp:562-575) over per-pair
    stats, accumulating parallax since the last keyframe. A scalar
    recurrence of T-1 steps: it runs on the host, in float32 like the JAX
    scan. ``lane_start`` [T-1] (folded lanes): pair j's second frame starts
    a lane, so it is a keyframe with a fresh carry. Returns is_kf [T]
    (frame 0 is a keyframe)."""
    count_sync(3)           # the three reads
    n_inl = n_inl.cpu().numpy()
    parallax = parallax.cpu().numpy().astype(np.float32)
    ok = ok.cpu().numpy()
    if lane_start is None:
        lane_start = np.zeros(len(n_inl), bool)
    acc = np.float32(0.0)
    last_kf = 0
    is_kf = np.zeros(len(n_inl) + 1, bool)
    is_kf[0] = True
    for j in range(len(n_inl)):
        i = j + 1
        acc = np.float32(0.0) if lane_start[j] else np.float32(acc + parallax[j])
        need = bool(lane_start[j]) or (
            bool(ok[j]) and n_inl[j] >= opts.min_keyframe_inliers
            and acc >= opts.min_parallax
            and (i - last_kf) >= opts.min_keyframe_gap)
        if need:
            acc = np.float32(0.0)
            last_kf = i
        is_kf[i] = need
    return is_kf


def default_lane_kf_capacity(T: int) -> int:
    """Keyframe capacity for a T-frame lane: the keyframe policy's
    ``min_keyframe_gap`` of 3 bounds a lane's keyframes at ceil(T/3) + 1,
    so ceil(T/3) + 8 never overflows at the default options; between 16
    and 128 (the JAX package's rule)."""
    return max(16, min(128, -(-T // 3) + 8))


def build_keyframe_map(
    cam: CameraParams,
    opts: TrackingOptions,
    kf_q: torch.Tensor,        # [K,4]
    kf_t: torch.Tensor,        # [K,3]
    kf_id: torch.Tensor,       # [K] int32, -1 = dead slot
    kf_px: torch.Tensor,       # [K,N,2]
    kf_desc: torch.Tensor,     # [K,N,32] uint8
    kf_fvalid: torch.Tensor,   # [K,N]
    kf_depth: torch.Tensor,    # [K,N]
    lm_capacity: int,
    pair_chunk: int = 16,
    pair_valid: torch.Tensor | None = None,  # [K-1] (False across lanes)
    link_strides: tuple[int, ...] = (1,),
):
    """A MapState from posed keyframe observations in one batch:
    depth-backprojected landmarks with contiguous allocation in
    (keyframe, feature) order, then observation links from matching each
    keyframe with the next (and, per extra entry of ``link_strides``, with
    the keyframe that many slots ahead: a third view for mono BA).
    ``pair_valid`` masks the keyframe pairs of a lane-merged map that
    cross a lane boundary. Returns (MapState, PairLinks) of the stride-1
    pass."""
    K, N = kf_fvalid.shape
    dev = kf_q.device
    kvalid = kf_id >= 0
    kf_fvalid = kf_fvalid & kvalid[:, None]
    want = kf_fvalid & (kf_depth >= stages.MIN_DEPTH) & (kf_depth <= stages.MAX_DEPTH)
    pc = backproject(cam, kf_px, kf_depth)
    inv = se3_inverse(Pose(kf_q, kf_t))
    pw = se3_apply(Pose(inv.q[:, None], inv.t[:, None]), pc)    # [K,N,3] world
    want_flat = want.reshape(-1)
    rank = torch.cumsum(want_flat.long(), 0) - 1
    L = lm_capacity
    ok_alloc = want_flat & (rank < L)
    slots_flat = torch.where(ok_alloc, rank, FREE)
    n_created = ok_alloc.sum()

    Lp = L + N
    scatter_idx = torch.where(ok_alloc, rank, Lp)
    order = stable_argsort(scatter_idx)
    sidx = scatter_idx[order]
    # allocation is contiguous: every created slot is written exactly once
    new = rank[ok_alloc]
    lm_pos = torch.zeros((3, Lp), dtype=torch.float32, device=dev)
    lm_pos[:, new] = pw.reshape(-1, 3)[ok_alloc].T
    lm_alive = torch.zeros((Lp,), dtype=torch.bool, device=dev)
    lm_alive[new] = True
    lm_obs = torch.zeros((Lp,), dtype=torch.int32, device=dev)
    lm_obs[new] = 1
    # two boolean-mask reads and two host scalars copied in
    count_sync(4)

    i32 = lambda v: torch.as_tensor(v, device=dev).to(torch.int32)
    ms = MapState(
        kf_q=kf_q, kf_t=kf_t, kf_id=kf_id.to(torch.int32),
        kf_px=kf_px.transpose(1, 2).contiguous(),
        kf_desc=kf_desc, kf_fvalid=kf_fvalid,
        kf_feat_lm=slots_flat.reshape(K, N).to(torch.int32),
        kf_depth=kf_depth,
        lm_pos=lm_pos, lm_alive=lm_alive, lm_obs=lm_obs,
        next_kf=i32(kvalid.sum()),
        next_lm=i32(torch.clamp(n_created, max=L)),
        lm_dropped=i32(want_flat.sum() - n_created),
    )
    ms, adopter, creator = _link_consecutive_keyframes(ms, cam, opts, pair_chunk,
                                                       pair_valid)
    # each further stride adopts into the features still FREE; the links
    # returned stay the stride-1 structure
    for s in link_strides:
        if s == 1:
            continue
        pv = None
        if pair_valid is not None:
            # same lane for stride s: the stride-1 lane mask composed
            pv = pair_valid[:K - s]
            for j in range(1, s):
                pv = pv & pair_valid[j:j + K - s]
        ms, _, _ = _link_consecutive_keyframes(ms, cam, opts, pair_chunk, pv,
                                               stride=s)
    links = PairLinks(created=ok_alloc.reshape(K, N), adopter=adopter,
                      creator=creator, order=order, sidx=sidx)
    return ms, links


def _link_consecutive_keyframes(ms: MapState, cam: CameraParams,
                                opts: TrackingOptions, pair_chunk: int = 16,
                                pair_valid: torch.Tensor | None = None,
                                stride: int = 1):
    """Match each keyframe to the one ``stride`` slots ahead and point the
    later keyframe's matched FREE features at the earlier one's landmarks,
    gated by reprojection into the later keyframe; one query per target
    feature (best distance, then lowest query index). ``lm_prev`` is read
    from the pre-adoption table, so adoption never chains within a pass.
    ``pair_valid`` [K-stride] masks pairs (lane-merged maps: across
    lanes). Returns (ms, adopter [K,N], creator [K,N])."""
    K = ms.kf_capacity
    N = ms.n_features
    L = ms.lm_physical
    s = stride
    dev = ms.kf_q.device
    res = matching.MatchResult(*_chunked(
        lambda *a: tuple(matching.match_frames(*a)), pair_chunk,
        ms.kf_desc[:K - s], ms.kf_fvalid[:K - s], ms.kf_desc[s:],
        ms.kf_fvalid[s:]))

    lm_prev = ms.kf_feat_lm[:K - s].long()                   # [K-s,N]
    lm_next = ms.kf_feat_lm[s:].long()
    lmi = lm_prev.clamp(0, L - 1)
    pw = ms.lm_pos[:, lmi].permute(1, 2, 0)                  # [K-s,N,3]
    uv, ok_z, _ = project_pinhole(
        cam, Pose(ms.kf_q[s:, None], ms.kf_t[s:, None]), pw)
    px_at = take_rows(ms.kf_px[s:].transpose(1, 2), res.idx)
    err = torch.linalg.norm(uv - px_at, dim=-1)
    target_prev = torch.gather(lm_next, 1, res.idx)
    adopt = (res.valid & (lm_prev >= 0) & ok_z
             & (err <= opts.triangulation_max_reproj_error)
             & (target_prev < 0))
    if pair_valid is not None:
        adopt = adopt & pair_valid[:, None]

    # dedupe: one query per target feature (best distance first)
    combo = torch.where(adopt, res.idx.float() * 512.0
                        + torch.clamp(res.dist, max=511.0), torch.inf)
    order = stable_argsort(combo, dim=1)
    key_sorted = torch.gather(torch.where(adopt, res.idx, -1), 1, order)
    first = torch.cat([torch.ones_like(key_sorted[:, :1], dtype=torch.bool),
                       key_sorted[:, 1:] != key_sorted[:, :-1]], dim=1)
    winner = torch.zeros_like(adopt)
    winner.scatter_(1, order, first & (key_sorted >= 0))
    adopt = adopt & winner

    # scatter into a buffer with one spare column for the non-adopting rows
    rows = torch.where(adopt, res.idx, N)
    new_next = torch.cat([lm_next, lm_next.new_zeros(K - s, 1)], 1)
    new_next.scatter_(1, rows, torch.where(adopt, lm_prev, 0))
    kf_feat_lm = torch.cat([ms.kf_feat_lm[:s], new_next[:, :N].to(torch.int32)])

    qidx = torch.arange(N, device=dev).expand(K - s, N)
    creator_rows = torch.full((K - s, N + 1), -1, dtype=torch.int32, device=dev)
    creator_rows.scatter_(1, rows, torch.where(adopt, qidx, -1).to(torch.int32))
    none = torch.full((s, N), -1, dtype=torch.int32, device=dev)
    creator = torch.cat([none, creator_rows[:, :N]])
    adopter = torch.cat([torch.where(adopt, res.idx, -1).to(torch.int32), none])

    # observation counts: +1 per adopted link
    obs = torch.cat([ms.lm_obs, ms.lm_obs.new_zeros(1)])
    obs.index_add_(0, torch.where(adopt, lmi, L).reshape(-1),
                   torch.ones(adopt.numel(), dtype=obs.dtype, device=dev))
    return (ms._replace(kf_feat_lm=kf_feat_lm, lm_obs=obs[:L]), adopter,
            creator)


def _lane_draws(gen_seed: int, rows: int, n_hyp: int, n: int,
                device) -> torch.Tensor:
    """The uniforms of one lane's RANSAC problems of a stage: [rows, H, n]
    from a generator seeded ``gen_seed``; problem j of every lane uses row
    j (its index within the lane)."""
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    return torch.rand((rows, n_hyp, n), generator=gen, device=device)


def build_offline_pipeline(
    opts: TrackingOptions,
    *,
    n_features_cap: int = 1024,
    kf_capacity: int = 128,
    lm_capacity: int | None = None,
    extract_chunk: int = 8,
    pair_chunk: int = 32,
    pnp_hypotheses: int = 16,
    # one GN pass of global BA: the re-track stage re-estimates every frame
    # against the refined landmarks and dominates the final ATE
    refine_iterations: int = 1,
    gba_cg_iterations: int = 8,
    monocular: bool = False,
    retrack_refine_iters: int = 3,
    retrack_hypotheses: int = 8,
    mono_pair_hypotheses: int = 128,
    mono_lo_starts: int = 16,
    mono_polish_iters: int = 10,
    mono_score_top_k: int | None = None,
    mono_retrack_two_kf: bool = True,
    mono_sample_bias: float = 0.0,
    mono_link_strides: tuple[int, ...] = (1, 2),
    # the monocular loop closure, off by default as in the JAX package
    # (measured there on revisiting synthetic loops: no mechanism beat the
    # plain chain; scale-aligned ATE 0.27 -> 0.39 m with the merge)
    mono_loop_pairs: int = 0,
    mono_loop_merge: bool = False,
    mono_loop_min_gap: int = 12,
    mono_loop_min_inliers: int = 40,
    mono_gba_iterations: int = 10,
    mono_gba_max_reproj: float = 30.0,
    lanes: int = 1,
    orb_kwargs: dict | None = None,
):
    """Returns run(cam, images [T,H,W] u8, depths [T,H,W] f32, timings=None,
    stats=None) -> (MapState, OfflineOut), on the device of the inputs; its
    stages are also exposed as run.pre, run.refine and run.post, and the
    refine's solver options as run.gba_opts and run.wide_gba_opts (None
    without the loop merge).
    ``timings``: if a dict is given (``utils/logging.StageClock``), it gets,
    accumulated over calls and each key written when its interval ends:
    each stage's seconds (``extract``, ``pairs``, ``map``, ``refine``,
    ``retrack``; with the mono loop closure also ``loop_scale``,
    ``loop_merge``, ``refine_wide``), the stages then synchronizing the
    device at their ends; ``"<stage>/<span>"``, the host seconds, without a
    synchronize, of a stage's parts from the previous lap or span to the
    end of a ``match_frames`` call (``match``), of ``pnp_ransac``'s and
    ``essential_ransac``'s work outside Gauss-Newton (``ransac``) and of a
    ``_pose_gn_refine`` call (``gn``), so a stage's spans sum to at most its
    seconds; and ``"#host_syncs"``, the places the pass made the host wait
    for the device (device-to-host reads, blocking copies in, status
    checks), the clock's own synchronizes not counted. ``stats``: if a
    dict is given, it gets the loop closure's counts (reading them
    synchronizes).

    ``monocular``: the depth input is ignored (pass zeros); poses and
    landmarks live in the scale of the chain (2 m median depth at each
    lane's first pair). The ``mono_*`` knobs are the JAX package's: the
    pair stage's essential RANSAC budget (hypotheses, LO starts, polish
    steps, two-tier width, PROSAC bias exp(-distance / bias)), the link
    strides of the map, and the re-track against the following keyframe
    too.

    Loop closure (mono, ``mono_loop_pairs`` > 0, per lane): every frame
    with a verified earlier revisit at least ``mono_loop_min_gap`` frames
    back re-anchors the chain's scale (``_scale_loop_correction``); with
    ``mono_loop_merge`` also up to ``mono_loop_pairs`` revisiting keyframe
    pairs per lane with ``mono_loop_min_inliers`` matches merge their
    landmarks (``_close_loops``), and the refine first runs a wide
    ``global_ba`` (``mono_gba_iterations`` GN steps, at least 16 CG steps,
    gate ``mono_gba_max_reproj`` px) before the standard one.
    ``orb_kwargs``: options of ``orb_extract`` (``n_features``,
    ``resize_f32``, ...).

    ``lm_capacity``: rows of the landmark table; None sizes it to
    B x ``kf_capacity`` x ``n_features_cap``, the allocator's worst case, so
    no landmark is dropped; a smaller table counts the ones that did not
    fit in ``lm_dropped``.

    ``lanes=B``: the input is B lanes of T/B frames concatenated (module
    docstring); ``kf_capacity`` is per lane and ``lm_capacity`` counts the
    merged table. The per-lane counts of ``OfflineOut`` are then [B];
    ``run_offline_pipeline_batched`` splits the result per lane."""
    B = lanes
    N = n_features_cap
    K = kf_capacity                     # per lane
    orb_kw = dict(orb_kwargs or {})     # e.g. n_features, resize_f32
    KT = B * K                          # keyframe slots of the folded map
    L = B * K * N if lm_capacity is None else lm_capacity
    loop_merge = monocular and mono_loop_pairs > 0 and mono_loop_merge

    def pair_pose(cam, pts3d, pts2d, vv, dcur, refine, noise):
        ident = identity_pose((len(vv),), device=vv.device)
        sol = pnp_ransac(cam, pts3d, pts2d, vv, None, opts.max_reproj_error,
                         n_hypotheses=pnp_hypotheses, refine_iters=refine,
                         init_pose=ident, depth_curr=dcur, noise=noise)
        ok = (sol.ok & (sol.n_inliers >= opts.min_inliers)
              & torch.isfinite(sol.pose.q).all(-1)
              & torch.isfinite(sol.pose.t).all(-1))
        return sol.pose, sol.n_inliers, ok

    def run_pre(cam: CameraParams, images, depths, clock=None):
        clock = clock or StageClock(None, images.device)
        clock.begin("extract")
        loop_stats = {}
        dev = images.device
        T = images.shape[0]
        if T % B:
            raise ValueError(f"{T} frames do not fold into {B} lanes")
        T_lane = T // B
        ident = identity_pose(device=dev)
        pair_ix = torch.arange(T - 1, device=dev)
        wl_pair = pair_ix % T_lane                  # index within the lane
        # pair i crosses a lane boundary iff frame i+1 starts a lane
        pair_xlane = wl_pair == T_lane - 1
        xlane_np = (np.arange(T - 1) % T_lane) == T_lane - 1

        # ---- 1. extraction in chunks of frames ----
        feats = []
        for i in range(0, T, extract_chunk):
            px_c, _, desc_c, valid_c = orb_extract(
                images[i:i + extract_chunk], n_slots=N, **orb_kw)
            dfeat_c = (None if monocular else stages.sample_depth_image(
                depths[i:i + extract_chunk], px_c, valid_c))
            feats.append((px_c, desc_c, valid_c, dfeat_c))
        px, desc, valid = (torch.cat(p) for p in list(zip(*feats))[:3])
        dfeat = None if monocular else torch.cat([f[3] for f in feats])
        clock.lap("extract")
        clock.begin("pairs")

        # ---- 2+3. consecutive-pair matching + relative pose (light GN
        # polish: this pose only seeds the keyframe policy and the VO
        # chain; the re-track stage re-estimates every frame) ----
        if monocular:
            u_pair = _lane_draws(29, T_lane, mono_pair_hypotheses, N, dev)
            (rq, rt, n_inl, ok, n_matches, parallax, zq_u, zn_u,
             midx) = _chunked(
                lambda *a: pair_track_mono(cam, u_pair, *a), pair_chunk,
                desc[:-1], valid[:-1], desc[1:], valid[1:], px[:-1], px[1:],
                wl_pair, lanes=B)
            rt, dfeat = _scale_chain(zq_u, zn_u, midx, rt, pair_xlane,
                                     pair_ix, T_lane)
            if mono_loop_pairs > 0:
                clock.lap("pairs")
                clock.begin("loop_scale")
                # the revisit gate needs only the rotation-only VO prefix,
                # which does not depend on the scale
                rot = _segmented_compose_scan(
                    torch.where((ok & ~pair_xlane)[:, None], rq, ident.q),
                    torch.zeros_like(rt), pair_xlane).q
                factor, loop_ver = _scale_loop_correction(
                    desc, valid, dfeat, torch.cat([ident.q[None], rot]), B,
                    mono_loop_min_gap)
                rt = rt * factor[:-1, None]
                dfeat = dfeat * factor[:, None]
                loop_stats.update(factor=factor, verified=loop_ver)
                clock.lap("loop_scale")
                clock.begin("pairs")
        else:
            u_pair = _lane_draws(29, T_lane, pnp_hypotheses, N, dev)

            def pair_track(dq, vq, dt, vt, pxq, pxt, ddq, ddt, wl):
                m = matching.match_frames(dq, vq, dt, vt)
                pc = backproject(cam, pxq, ddq)
                pvalid = (m.valid & (ddq >= stages.MIN_DEPTH)
                          & (ddq <= stages.MAX_DEPTH))
                pose, n_i, ok_i = pair_pose(
                    cam, pc, take_rows(pxt, m.idx), pvalid,
                    torch.gather(ddt, 1, m.idx), 2, u_pair[wl])
                return (pose.q, pose.t, n_i, ok_i,
                        m.valid.sum(-1).to(torch.int32),
                        stages.parallax_px(pxq, pxt, m))

            rq, rt, n_inl, ok, n_matches, parallax = _chunked(
                pair_track, pair_chunk,
                desc[:-1], valid[:-1], desc[1:], valid[1:],
                px[:-1], px[1:], dfeat[:-1], dfeat[1:], wl_pair, lanes=B)
        # cross-lane pairs never track; their stats leak nowhere
        ok = ok & ~pair_xlane
        n_inl = torch.where(pair_xlane, 0, n_inl)
        n_matches = torch.where(pair_xlane, 0, n_matches)
        parallax = torch.where(pair_xlane, 0.0, parallax)
        rel_ok = ok
        if monocular:
            # constant-velocity fallback: a failed pair inherits its
            # predecessor's relative pose (already in world scale) when
            # that one tracked within the lane; the frame still counts as
            # untracked unless the re-track verifies it
            no = torch.zeros(1, dtype=torch.bool, device=dev)
            use_prev = (~ok & torch.cat([no, ok[:-1]])
                        & torch.cat([no, ~pair_xlane[:-1]]) & ~pair_xlane)
            rq = torch.where(use_prev[:, None], torch.cat([rq[:1], rq[:-1]]), rq)
            rt = torch.where(use_prev[:, None], torch.cat([rt[:1], rt[:-1]]), rt)
            rel_ok = ok | use_prev
        clock.lap("pairs")
        clock.begin("map")

        # ---- 4. absolute poses: T_cw[i+1] = rel[i] ∘ ... ∘ rel[0], reset
        # at every lane start (whose cross-lane pair is the identity) ----
        prefix = _segmented_compose_scan(
            torch.where(rel_ok[:, None], rq, ident.q),
            torch.where(rel_ok[:, None], rt, ident.t), pair_xlane)
        poses = Pose(torch.cat([ident.q[None], _normalized(prefix.q)]),
                     torch.cat([ident.t[None], prefix.t]))
        lane_start = (torch.arange(T, device=dev) % T_lane) == 0
        tracked = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ok]) | lane_start

        # ---- 5. keyframe policy (host) ----
        is_kf_np = _keyframe_policy(opts, n_inl, parallax, ok,
                                    xlane_np if B > 1 else None)

        # ---- 6. the last K keyframes of each lane, ascending, dead slots
        # first ----
        sel_np = np.full((B, K), -1, np.int64)
        for b in range(B):
            f = b * T_lane + np.flatnonzero(is_kf_np[b * T_lane:(b + 1) * T_lane])[-K:]
            sel_np[b, K - len(f):] = f
        sel = torch.from_numpy(sel_np.reshape(KT)).to(dev)
        count_sync()            # sel's copy to the device
        kvalid = sel >= 0
        slot_frame = sel.clamp(min=0)
        kf_px = px[slot_frame]
        kf_desc = desc[slot_frame]
        kf_fvalid = valid[slot_frame] & kvalid[:, None]
        kf_depth = dfeat[slot_frame]

        # ---- 6b. keyframe chain: direct PnP between consecutive keyframes
        # (RGB-D), the VO relative pose where it fails; mono keeps the VO
        # chain. Each lane block's first slot anchors its segment at its
        # own VO pose ----
        kpair_within = torch.arange(KT - 1, device=dev) % K
        kpair_xlane = kpair_within == K - 1
        vo_q, vo_t = poses.q[slot_frame], poses.t[slot_frame]
        vo_rel = se3_compose(Pose(vo_q[1:], vo_t[1:]),
                             se3_inverse(Pose(vo_q[:-1], vo_t[:-1])))
        if monocular:
            rel_k = vo_rel
        else:
            u_kf = _lane_draws(31, K, pnp_hypotheses, N, dev)

            def kf_pair_track(dq, vq, dt, vt, pxq, pxt, ddq, ddt, wl):
                m = matching.match_frames(dq, vq, dt, vt)
                pc = backproject(cam, pxq, ddq)
                pvalid = (m.valid & (ddq >= stages.MIN_DEPTH)
                          & (ddq <= stages.MAX_DEPTH))
                pose, _, ok_i = pair_pose(
                    cam, pc, take_rows(pxt, m.idx), pvalid,
                    torch.gather(ddt, 1, m.idx), 4, u_kf[wl])
                return pose.q, pose.t, ok_i

            rk_q, rk_t, ok_k = _chunked(
                kf_pair_track, pair_chunk,
                kf_desc[:-1], kf_fvalid[:-1], kf_desc[1:], kf_fvalid[1:],
                kf_px[:-1], kf_px[1:], kf_depth[:-1], kf_depth[1:],
                kpair_within, lanes=B)
            use_k = (ok_k & kvalid[1:] & kvalid[:-1] & ~kpair_xlane)[:, None]
            rel_k = Pose(torch.where(use_k, rk_q, vo_rel.q),
                         torch.where(use_k, rk_t, vo_rel.t))
        kstart = (torch.arange(KT, device=dev) % K) == 0
        chain_q = torch.where(kstart[:, None], vo_q, torch.cat([vo_q[:1], rel_k.q]))
        chain_t = torch.where(kstart[:, None], vo_t, torch.cat([vo_t[:1], rel_k.t]))
        kf_abs = _segmented_compose_scan(chain_q, chain_t, kstart)
        ms, links = build_keyframe_map(
            cam, opts, _normalized(kf_abs.q), kf_abs.t, sel.to(torch.int32),
            kf_px, kf_desc, kf_fvalid, kf_depth, L, pair_chunk=pair_chunk,
            pair_valid=None if B == 1 else ~kpair_xlane,
            # mono: a stride-2 pass gives landmarks a third view, so global
            # BA couples the chain's relative scales over two hops
            link_strides=tuple(mono_link_strides) if monocular else (1,))
        clock.lap("map")
        if loop_merge:
            clock.begin("loop_merge")
            # folded lanes: candidates within a lane block, budget per lane
            ms, n_ver, n_merged = _close_loops(
                ms, mono_loop_pairs * B, mono_loop_min_gap,
                mono_loop_min_inliers, slots_per_lane=None if B == 1 else K)
            loop_stats.update(pairs_verified=n_ver, links_merged=n_merged)
            clock.lap("loop_merge")
        count_sync()            # is_kf's copy to the device
        aux = dict(poses_q=poses.q, poses_t=poses.t, tracked=tracked,
                   n_inl=n_inl, n_matches=n_matches, parallax=parallax,
                   is_kf=torch.from_numpy(is_kf_np).to(dev), px=px, desc=desc,
                   valid=valid, dfeat=dfeat,
                   lane_lm=links.created.reshape(B, K * N).sum(1).to(torch.int32),
                   loop=loop_stats)
        return ms, links, aux

    def pair_track_mono(cam, u_pair, dq, vq, dt, vt, pxq, pxt, wl):
        """Essential RANSAC + two-view triangulation for a chunk of pairs:
        the unit-baseline relative pose, and the triangulated depths of
        the scale chain (zq: query feature n in the query frame; zn: its
        match in the train frame), 0 where they fail cheirality or the
        relative far gate (10 x the pair's median depth)."""
        m = matching.match_frames(dq, vq, dt, vt)
        px_n = take_rows(pxt, m.idx)
        logw = None if mono_sample_bias <= 0.0 else -m.dist / mono_sample_bias
        sol = essential_ransac(cam, pxq, px_n, m.valid, None,
                               n_hypotheses=mono_pair_hypotheses,
                               lo_starts=mono_lo_starts,
                               polish_iters=mono_polish_iters,
                               score_top_k=mono_score_top_k,
                               sample_logw=logw, noise=u_pair[wl])
        P1 = torch.eye(3, 4, dtype=pxq.dtype, device=pxq.device)
        P2 = torch.cat([sol.R, sol.t[:, :, None]], -1)
        X = triangulate_dlt(P1, P2, _normalize_px(cam, pxq),
                            _normalize_px(cam, px_n))        # [P,N,3] query cam
        zq = X[..., 2]
        zn = (X @ sol.R.transpose(-1, -2) + sol.t[:, None, :])[..., 2]
        zgood = (m.valid & sol.inlier_mask & (zq > 1e-3) & (zn > 1e-3)
                 & torch.isfinite(X).all(-1))
        zmed = torch.nan_to_num(nanmedian(torch.where(zgood, zq, torch.nan)),
                                nan=1.0)
        zcap = (10.0 * torch.clamp(zmed, min=1e-3))[:, None]
        zgood = zgood & (zq < zcap) & (zn < zcap)
        ok = sol.ok & (sol.n_inliers >= opts.min_inliers)
        return (matrix_to_quat(sol.R), sol.t, sol.n_inliers, ok,
                m.valid.sum(-1).to(torch.int32),
                stages.parallax_px(pxq, pxt, m),
                torch.where(zgood, zq, 0.0), torch.where(zgood, zn, 0.0), m.idx)

    gba_opts = GlobalBAOptions(max_iterations=max(refine_iterations, 1),
                               cg_iterations=gba_cg_iterations)
    # after a loop merge: a wide phase whose gate admits the drifted loop
    # observations and whose GN budget lets the correction spread along
    # the chain, then the standard polish
    wide_gba_opts = GlobalBAOptions(max_iterations=mono_gba_iterations,
                                    cg_iterations=max(gba_cg_iterations, 16),
                                    max_reproj_error=mono_gba_max_reproj)

    def run_refine(cam: CameraParams, ms: MapState, clock=None) -> MapState:
        clock = clock or StageClock(None, ms.kf_q.device)
        # folded lanes: one merged solve, gauge-grouped per lane block
        gg = (None if B == 1 else torch.arange(B, device=ms.kf_q.device)
              .repeat_interleave(K))
        if loop_merge:
            clock.begin("refine_wide")
            ms, _ = global_ba(ms, cam, wide_gba_opts, gauge_group=gg)
            clock.lap("refine_wide")
            clock.begin("refine")
        ms, _ = global_ba(ms, cam, gba_opts, gauge_group=gg)
        return ms

    def run_post(cam: CameraParams, ms: MapState, aux: dict):
        poses = Pose(aux["poses_q"], aux["poses_t"])
        is_kf, px, desc = aux["is_kf"], aux["px"], aux["desc"]
        valid, dfeat = aux["valid"], aux["dfeat"]
        dev = is_kf.device
        T = is_kf.shape[0]
        T_lane = T // B
        kvalid = ms.kf_id >= 0
        slot_frame = ms.kf_id.long().clamp(min=0)

        # preceding keyframe of every frame, and its slot
        frame_ids = torch.arange(T, device=dev)
        prev_kf = torch.cummax(torch.where(is_kf, frame_ids, -1), 0).values
        prev_kf = prev_kf.clamp(min=0)
        slot_of_frame = torch.zeros(T + 1, dtype=torch.long, device=dev)
        slot_of_frame[torch.where(kvalid, slot_frame, T)] = torch.arange(
            KT, device=dev)                              # row T: dead slots
        kf_slot = slot_of_frame[:T][prev_kf]

        # fallback pose: re-anchor the VO chain to the refined keyframe,
        # T_cw'(f) = T_cw_vo(f) ∘ T_cw_vo(kf)^-1 ∘ T_cw_ref(kf)
        vo_kf = Pose(poses.q[prev_kf], poses.t[prev_kf])
        ref_kf = Pose(ms.kf_q[kf_slot], ms.kf_t[kf_slot])
        poses = se3_compose(poses, se3_compose(se3_inverse(vo_kf), ref_kf))

        # ---- 8. re-track every frame against its preceding keyframe's
        # landmarks; the re-anchored pose competes as the motion prior ----
        kd, kv, flm = ms.kf_desc[kf_slot], ms.kf_fvalid[kf_slot], ms.kf_feat_lm[kf_slot]
        if monocular and mono_retrack_two_kf:
            # mono: also the FOLLOWING keyframe's landmarks (the first
            # keyframe at or after the frame, within its lane and still
            # stored), so each frame sits between two anchors
            nk = -torch.flip(torch.cummax(torch.flip(
                torch.where(is_kf, -frame_ids, -(T + 1)), [0]), 0).values, [0])
            has_next = (nk <= T - 1) & ((nk // T_lane) == (frame_ids // T_lane))
            nk_c = torch.where(has_next, nk, prev_kf)
            slot2 = slot_of_frame[nk_c.clamp(max=T - 1)]
            use2 = has_next & (slot2 != kf_slot) & (ms.kf_id[slot2].long() == nk_c)
            kd = torch.cat([kd, ms.kf_desc[slot2]], 1)
            kv = torch.cat([kv, ms.kf_fvalid[slot2] & use2[:, None]], 1)
            flm = torch.cat([flm, ms.kf_feat_lm[slot2]], 1)
        Lp = ms.lm_physical
        u_rt = _lane_draws(37, T_lane, retrack_hypotheses, kd.shape[1], dev)

        def frame_retrack(kd, kv, flm, di, vi, pxi, pq, pt, wl, ddi=None):
            m = matching.match_frames(kd, kv, di, vi)
            lmf = flm.long().clamp(0, Lp - 1)
            p3 = ms.lm_pos[:, lmf].permute(1, 2, 0)      # [P,Nq,3] world
            pval = (m.valid & (flm >= 0) & ms.lm_alive[lmf]
                    & torch.isfinite(p3).all(-1))
            sol = pnp_ransac(
                cam, p3, take_rows(pxi, m.idx), pval, None,
                opts.max_reproj_error, n_hypotheses=retrack_hypotheses,
                refine_iters=retrack_refine_iters, init_pose=Pose(pq, pt),
                # mono: no sensor depth, DLT hypotheses
                depth_curr=None if ddi is None else torch.gather(ddi, 1, m.idx),
                noise=u_rt[wl])
            ok_i = (sol.ok & (sol.n_inliers >= opts.min_inliers)
                    & torch.isfinite(sol.pose.q).all(-1)
                    & torch.isfinite(sol.pose.t).all(-1))
            return sol.pose.q, sol.pose.t, sol.n_inliers, ok_i

        rt_q, rt_t, rt_inl, rt_ok = _chunked(
            frame_retrack, pair_chunk, kd, kv, flm, desc, valid, px, poses.q,
            poses.t, frame_ids % T_lane, *(() if monocular else (dfeat,)), lanes=B)
        poses = Pose(torch.where(rt_ok[:, None], rt_q, poses.q),
                     torch.where(rt_ok[:, None], rt_t, poses.t))
        zero_i = torch.zeros(1, dtype=torch.int32, device=dev)
        if B == 1:
            n_kf, n_lm = msl.n_keyframes(ms), msl.n_landmarks(ms)
        else:  # per lane [B]
            n_kf = kvalid.reshape(B, K).sum(1).to(torch.int32)
            n_lm = aux["lane_lm"]
        out = OfflineOut(
            pose=se3_matrix(poses),
            tracked=aux["tracked"] | rt_ok,
            n_matches=torch.cat([zero_i, aux["n_matches"]]),
            n_inliers=torch.where(rt_ok, rt_inl,
                                  torch.cat([zero_i, aux["n_inl"]])),
            parallax=torch.cat([aux["parallax"].new_zeros(1), aux["parallax"]]),
            is_keyframe=is_kf,
            n_keyframes=n_kf,
            n_landmarks=n_lm,
        )
        return ms, out

    def run(cam: CameraParams, images, depths, timings: dict | None = None,
            stats: dict | None = None):
        clock = StageClock(timings, images.device)
        with clock.active():
            ms, _, aux = run_pre(cam, images, depths, clock)
            clock.begin("refine")
            if refine_iterations > 0:
                ms = run_refine(cam, ms, clock)
            clock.lap("refine")
            clock.begin("retrack")
            ms, out = run_post(cam, ms, aux)
            clock.lap("retrack")
            if stats is not None:
                stats.update(_loop_counts(aux["loop"], B))
        return ms, out

    run.pre, run.refine, run.post = run_pre, run_refine, run_post
    run.gba_opts = gba_opts
    run.wide_gba_opts = wide_gba_opts if loop_merge else None
    return run


def _loop_counts(loop: dict, B: int) -> dict:
    """Host numbers of the loop closure's outputs (empty when it is off):
    frames whose revisit passed the gates, per lane and in all, the range of
    the scale factors, and the merge's verified keyframe pairs and merged
    landmark links."""
    out = {}
    if "factor" in loop:
        count_sync(4)
        ver = loop["verified"].reshape(B, -1)
        f = loop["factor"]
        out.update(loop_verified_frames=int(ver.sum()),
                   loop_verified_frames_per_lane=ver.sum(1).tolist(),
                   loop_factor_min=float(f.min()), loop_factor_max=float(f.max()))
    if "pairs_verified" in loop:
        count_sync(2)
        out.update(loop_pairs_verified=int(loop["pairs_verified"]),
                   loop_links_merged=int(loop["links_merged"]))
    return out


def _scale_chain(zq_u, zn_u, midx, rt, pair_xlane, pair_ix, T_lane: int):
    """Monocular scale: pair i-1 and pair i share frame i's features, so the
    median log-ratio of their triangulated depths (at least 8 shared)
    gives s_i / s_{i-1}; a per-lane prefix sum of the log-ratios scales
    every pair, and each lane's gauge puts the median depth of its first
    pair at 2 m. Returns the scaled translations [T-1,3] and the
    synthesized per-feature depths [T,N] (world scale; the frames without
    an outgoing same-lane pair get zeros)."""
    N = zq_u.shape[1]
    B = (len(pair_ix) + 1) // T_lane
    # cross-lane pairs relate unrelated frames: no depths from them
    zq_u = torch.where(pair_xlane[:, None], 0.0, zq_u)
    zn_u = torch.where(pair_xlane[:, None], 0.0, zn_u)
    d_in = zn_u[:-1]                                     # [T-2,N], scale s_{i-1}
    d_out = torch.gather(zq_u[1:], 1, midx[:-1])         # scale s_i
    shared = (d_in > 0.0) & (d_out > 0.0)
    logr = torch.where(shared, torch.log(torch.clamp(d_in, min=1e-9))
                       - torch.log(torch.clamp(d_out, min=1e-9)), torch.nan)
    med = torch.nan_to_num(nanmedian(logr, dim=1))
    log_ratio = torch.where(shared.sum(1) >= 8, med, 0.0)   # [T-2]
    cs = torch.cat([log_ratio.new_zeros(1), torch.cumsum(log_ratio, 0)])
    log_s = cs - cs[(pair_ix // T_lane) * T_lane]        # per-lane prefix
    zq0 = zq_u[torch.arange(B, device=zq_u.device) * T_lane]     # [B,N]
    med0 = nanmedian(torch.where(zq0 > 0, zq0, torch.nan), dim=1)
    c = 2.0 / torch.clamp(torch.nan_to_num(med0, nan=1.0), min=1e-6)
    s = torch.exp(log_s) * c[pair_ix // T_lane]          # [T-1]
    dfeat = torch.cat([zq_u * s[:, None], zq_u.new_zeros(1, N)])
    return rt * s[:, None], dfeat


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two long) by pairwise halving:
    elementwise adds in an order fixed by the length alone, so equal rows
    give equal sums, on any device and whatever the leading shape (a
    reduction kernel picks its order by the shape)."""
    n = x.shape[-1]
    while n > 1:
        n //= 2
        x = x[..., :n] + x[..., n:]
    return x[..., 0]


def _cos_angle(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """cos of the angle of Ra Rb^T, from its trace, for [..., 3, 3]."""
    tr = _tree_sum(F.pad((Ra * Rb).flatten(-2), (0, 7)))
    return torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)


def _cos_deg(deg: float) -> float:
    """cos of an angle in degrees, in float32 as the JAX package's gate
    constants are."""
    return float(torch.cos(torch.deg2rad(torch.tensor(deg, dtype=torch.float32))))


_LOG4 = float(torch.log(torch.tensor(4.0)))    # float32, as in the JAX gate


def _place_descriptors(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[M,256] float64 bag-of-bits descriptors of M frames, as integers:
    2 x each ORB bit's count over the n valid features, less n (n at least
    1). That is the JAX package's descriptor (each bit's rate less 0.5)
    times 2n, so it has the same cosines (the counts are integers, exact in
    float32 in any order)."""
    v = valid.float()
    C = torch.einsum("mnb,mn->mb", matching.unpack_bits(desc), v)
    return (2.0 * C - torch.clamp(v.sum(1), min=1.0)[:, None]).double()


def _block_similarity(H: torch.Tensor, blocks: int) -> torch.Tensor:
    """Float32 cosine similarities of the descriptors ``H`` within each of
    ``blocks`` equal runs of rows: [blocks, M/blocks, M/blocks] (the only
    candidates of a folded map). The dot products and squared norms of
    the integer descriptors (at most 256 x 1024^2 < 2^53) are exact in
    float64 whatever the order of the sum, so copies of a frame tie exactly
    and a folded lane gets its single run's values; memory is O(M^2 /
    blocks)."""
    Hb = H.reshape(blocks, -1, H.shape[-1])
    nrm = torch.clamp(torch.sqrt((Hb * Hb).sum(-1)), min=1.0)   # H = 0: cos 0
    dot = torch.bmm(Hb, Hb.transpose(1, 2))
    return (dot / (nrm[:, :, None] * nrm[:, None, :])).float()


def _best_candidate(sim: torch.Tensor, cand: torch.Tensor):
    """(index within the block of the most similar candidate, its
    similarity; -inf where there is none) per row of [B,M,M]; ties go to
    the lowest index, as ``jnp.argmax``'s."""
    simm = torch.where(cand, sim, -torch.inf)
    return torch.argmax(simm, -1), simm.amax(-1)


def _box5(x: torch.Tensor) -> torch.Tensor:
    """Sum over the 5-frame window centred on each entry of every row of
    [B,T] (zeros past the row's ends: ``jnp.convolve(.., ones(5),
    "same")`` per lane), by elementwise adds in a fixed order."""
    n = x.shape[-1]
    p = F.pad(x, (2, 2))
    return p[..., :n] + p[..., 1:n + 1] + p[..., 2:n + 2] + p[..., 3:n + 3] + p[..., 4:n + 4]


def _scale_loop_correction(desc: torch.Tensor, valid: torch.Tensor,
                           dfeat: torch.Tensor, frame_q: torch.Tensor,
                           B_lanes: int, min_gap: int,
                           max_rot_deg: float = 35.0, min_sim: float = 0.55,
                           min_depth_count: int = 16):
    """Monocular scale re-anchoring at revisits (the JAX package's
    ``_scale_loop_correction``; the chain's scale error is a random walk,
    so it is corrected frame by frame, not as a ramp).

    Each frame's partner is the most similar earlier frame of its lane at
    least ``min_gap`` frames back (bag-of-bits cosine). The pair is
    verified by similarity >= ``min_sim``, the VO chain's relative rotation
    within ``max_rot_deg`` (``frame_q`` [T,4], the rotation-only prefix; a
    true revisit has ~zero baseline, where an epipolar check degenerates),
    at least ``min_depth_count`` synthesized depths at both ends and a
    median log-depth difference within log 4. That difference, smoothed
    over 5 frames of the lane (verified frames weighted 1, others 0), is
    the frame's log-scale error. Returns (factor [T], the per-frame scale
    multipliers, 1 where nothing was verified nearby; verified [T] bool).
    """
    T = valid.shape[0]
    T_lane = T // B_lanes
    dev = valid.device
    sim = _block_similarity(_place_descriptors(desc, valid), B_lanes)
    tl = torch.arange(T_lane, device=dev)
    cand = (tl[:, None] - tl[None, :]) >= min_gap            # partner earlier
    part, psim = _best_candidate(sim, cand.expand(B_lanes, -1, -1))
    part = (part + (torch.arange(B_lanes, device=dev) * T_lane)[:, None]).reshape(T)
    psim = psim.reshape(T)

    R = quat_to_matrix(frame_q)
    cos_ang = _cos_angle(R, R[part])
    dvalid = dfeat > 1e-6
    cnt = dvalid.sum(1)
    ld = torch.where(dvalid, torch.log(torch.clamp(dfeat, min=1e-9)), torch.nan)
    med = torch.nan_to_num(nanmedian(ld, dim=1))
    delta_raw = med - med[part]
    ver = (torch.isfinite(psim) & (psim >= min_sim)
           & (cos_ang >= _cos_deg(max_rot_deg))
           & (cnt >= min_depth_count) & (cnt[part] >= min_depth_count)
           & (delta_raw.abs() <= _LOG4))
    w = ver.float().reshape(B_lanes, T_lane)
    num = _box5(torch.where(ver, delta_raw, 0.0).reshape(B_lanes, T_lane) * w).reshape(T)
    den = _box5(w).reshape(T)
    delta_s = torch.where(den > 0, num / torch.clamp(den, min=1.0), 0.0)
    return torch.exp(-delta_s), ver


def _greedy_pairs(best_t: np.ndarray, best_s: np.ndarray, n_pairs: int,
                  spl: int):
    """The revisit pairs to verify, on the host: queries by falling
    similarity (stable), each taken when neither end was taken before, then
    the first ``n_pairs / lanes`` taken of each lane into that lane's
    block of the budget. Returns (query, target) slots [n_pairs], -1 where
    a block is not full."""
    K = len(best_t)
    order = np.argsort(-best_s, kind="stable")
    used = np.zeros(K, bool)
    n_lanes = K // spl
    per_lane = n_pairs // n_lanes
    taken = np.zeros(n_lanes, np.int64)
    qs = np.full(n_pairs, -1, np.int64)
    ts = np.full(n_pairs, -1, np.int64)
    for qi in order:
        ti = best_t[qi]
        if not np.isfinite(best_s[qi]) or used[qi] or used[ti]:
            continue
        used[qi] = used[ti] = True
        lane = qi // spl
        if taken[lane] < per_lane:
            qs[lane * per_lane + taken[lane]] = qi
            ts[lane * per_lane + taken[lane]] = ti
        taken[lane] += 1
    return qs, ts


def _last_occurrence(idx: torch.Tensor) -> torch.Tensor:
    """[R] bool: entry r is the last of the entries holding its value, in
    flat order (what the JAX package's scatters keep on duplicates). A
    scatter through only these entries has no duplicate target, so it is
    deterministic on CUDA too."""
    order = stable_argsort(idx)
    s = idx[order]
    last = torch.cat([s[1:] != s[:-1], torch.ones_like(s[:1], dtype=torch.bool)])
    out = torch.empty_like(last)
    out[order] = last
    return out


def _close_loops(ms: MapState, n_pairs: int, min_gap_frames: int,
                 min_inliers: int, slots_per_lane: int | None = None,
                 max_rot_deg: float = 35.0):
    """Monocular loop closure as landmark merges (the JAX package's
    ``_close_loops``): revisiting keyframe pairs found by bag-of-bits
    similarity, verified by match count and the map's relative rotation,
    and the later keyframe's landmarks merged into the earlier one's, so
    the merged landmarks carry observations from both ends of the loop.

    1. Each keyframe's candidate is its most similar keyframe at least
       ``min_gap_frames`` frames LATER (within its lane block of
       ``slots_per_lane`` slots in a folded map).
    2. Greedy selection without a shared slot, ``n_pairs`` in all, split
       evenly over the lanes (``_greedy_pairs``; one read of the device).
    3. ``match_frames`` on the selected pairs; a pair counts with at least
       ``min_inliers`` matches and a map rotation within ``max_rot_deg``
       (a same-scene pair seen from the opposite side has real parallax).
    4. Matched live landmark pairs (early, late) merge: the late one is
       remapped to the early one and dies. A merge whose early landmark
       dies elsewhere, or whose late one survives elsewhere, is dropped so
       that one gather remaps the table; a late landmark matched twice
       takes the last match in flat order. Observation counts are rebuilt
       from the links.

    Returns (ms, pairs verified, landmark links merged), counts as 0-d
    int32 tensors."""
    K, N = ms.kf_fvalid.shape
    Lp = ms.lm_physical
    dev = ms.kf_q.device
    kvalid = ms.kf_id >= 0
    fvalid = ms.kf_fvalid & kvalid[:, None]
    spl = K if slots_per_lane is None else min(slots_per_lane, K)
    n_lanes = K // spl

    # ---- 1. place recognition, within lane blocks ----
    sim = _block_similarity(_place_descriptors(ms.kf_desc, fvalid), n_lanes)
    kid = ms.kf_id.long().reshape(n_lanes, spl)
    kv = kvalid.reshape(n_lanes, spl)
    cand = (kv[:, :, None] & kv[:, None, :]
            & ((kid[:, None, :] - kid[:, :, None]) >= min_gap_frames))
    best, best_s = _best_candidate(sim, cand)
    best_t = best + (torch.arange(n_lanes, device=dev) * spl)[:, None]

    # ---- 2. greedy slot-unique selection on the host ----
    host = torch.stack([best_t.reshape(K).double(), best_s.reshape(K).double()]).cpu().numpy()
    qs, ts = _greedy_pairs(host[0].astype(np.int64), host[1].astype(np.float32),
                           n_pairs, spl)
    sel = torch.from_numpy(np.stack([qs, ts])).to(dev)
    count_sync(2)           # the read and the copy back
    active = sel[0] >= 0
    qc, tc = sel[0].clamp(min=0), sel[1].clamp(min=0)

    # ---- 3. match + map-rotation verification ----
    res = matching.match_frames(ms.kf_desc[qc], fvalid[qc] & active[:, None],
                                ms.kf_desc[tc], fvalid[tc])
    inl = res.valid & active[:, None]
    cos_ang = _cos_angle(quat_to_matrix(ms.kf_q[tc]), quat_to_matrix(ms.kf_q[qc]))
    pair_ok = (active & (inl.sum(1) >= min_inliers)
               & (cos_ang >= _cos_deg(max_rot_deg)))

    # ---- 4. conflict-free landmark merge ----
    alive = ms.lm_alive
    lmq = ms.kf_feat_lm[qc].long()                               # [P,N]
    lmt = torch.gather(ms.kf_feat_lm[tc].long(), 1, res.idx)
    cq, ct = lmq.clamp(0, Lp - 1), lmt.clamp(0, Lp - 1)
    okl = (inl & pair_ok[:, None] & (lmq >= 0) & (lmt >= 0) & (lmq != lmt)
           & alive[cq] & alive[ct])

    def flags(idx):   # [Lp] bool: the rows named by idx (Lp: none)
        return torch.zeros(Lp + 1, dtype=torch.bool, device=dev).index_fill_(
            0, idx.reshape(-1), True)[:Lp]

    in_keep = flags(torch.where(okl, lmq, Lp))
    in_die = flags(torch.where(okl, lmt, Lp))
    safe = okl & ~in_die[cq] & ~in_keep[ct]
    src = torch.where(safe, lmt, Lp).reshape(-1)
    dst = torch.where(safe, lmq, 0).reshape(-1)
    remap = torch.arange(Lp + 1, device=dev)
    remap[torch.where(_last_occurrence(src), src, Lp)] = dst
    flm = ms.kf_feat_lm
    new_flm = torch.where(flm >= 0, remap[flm.long().clamp(0, Lp - 1)].to(flm.dtype), flm)
    lm_alive = alive & ~flags(src)
    hist = torch.zeros(Lp + 1, dtype=ms.lm_obs.dtype, device=dev)
    linked = torch.where(fvalid & (new_flm >= 0), new_flm.long(), Lp).reshape(-1)
    hist.index_add_(0, linked, torch.ones_like(linked, dtype=hist.dtype))
    ms = ms._replace(kf_feat_lm=new_flm, lm_alive=lm_alive,
                     lm_obs=torch.where(lm_alive, hist[:Lp], 0))
    return ms, pair_ok.sum().to(torch.int32), safe.sum().to(torch.int32)


def split_merged_lanes(ms: MapState, B: int, K: int, N: int, T_lane: int,
                       lane_lm: torch.Tensor) -> MapState:
    """Split a lane-merged MapState (B*K keyframe slots, lane-major
    contiguous landmark allocation, as the ``lanes=B`` pipeline builds it)
    into per-lane MapStates on a leading [B] axis: lane b's landmarks are
    the merged rows [start_b, start_b + lane_lm[b]) (start_b the exclusive
    prefix sum), gathered into a table of K*N + N rows with the links
    re-offset and the keyframe ids made lane-relative, which is the table a
    per-lane build produces."""
    dev = ms.kf_q.device
    lane_lm = lane_lm.long()
    starts = torch.cumsum(lane_lm, 0) - lane_lm                  # [B]
    Lp_lane = K * N + N
    row = torch.arange(Lp_lane, device=dev)
    src = (starts[:, None] + row[None, :]).clamp(max=ms.lm_physical - 1)
    live = row[None, :] < lane_lm[:, None]                       # [B,Lp_lane]
    lanes = lambda x: x.reshape(B, K, *x.shape[1:])
    flm = lanes(ms.kf_feat_lm)
    flm = torch.where(flm >= 0, flm - starts[:, None, None].to(flm.dtype), flm)
    kf_id = lanes(ms.kf_id)
    base = (torch.arange(B, device=dev) * T_lane)[:, None].to(kf_id.dtype)
    kf_id = torch.where(kf_id >= 0, kf_id - base, -1)
    return MapState(
        kf_q=lanes(ms.kf_q), kf_t=lanes(ms.kf_t), kf_id=kf_id,
        kf_px=lanes(ms.kf_px), kf_desc=lanes(ms.kf_desc),
        kf_fvalid=lanes(ms.kf_fvalid), kf_feat_lm=flm,
        kf_depth=lanes(ms.kf_depth),
        lm_pos=ms.lm_pos[:, src].permute(1, 0, 2),               # [B,3,Lp_lane]
        lm_alive=ms.lm_alive[src] & live,
        lm_obs=torch.where(live, ms.lm_obs[src], 0),
        next_kf=(kf_id >= 0).sum(1).to(torch.int32),
        next_lm=lane_lm.to(torch.int32),
        lm_dropped=torch.zeros(B, dtype=torch.int32, device=dev),
    )


def run_offline_pipeline(
    cam: CameraParams,
    images_u8,                # [T,H,W] uint8 (tensor or numpy)
    depths_m,                 # [T,H,W] float32 (zeros in mono)
    opts: TrackingOptions,
    device="cuda",
    timings: dict | None = None,
    stats: dict | None = None,
    **kw,                     # build_offline_pipeline options
) -> tuple[MapState, OfflineOut]:
    """The offline pipeline on ``device`` with the JAX package's defaults
    (RGB-D, or ``monocular=True`` with the ``mono_*`` knobs); returns
    (MapState, OfflineOut). ``timings``, ``stats``: see
    ``build_offline_pipeline``."""
    dev = torch.device(device)
    images = torch.as_tensor(images_u8).to(dev)
    depths = torch.as_tensor(depths_m).to(dev, torch.float32)
    return build_offline_pipeline(opts, **kw)(cam, images, depths, timings, stats)


def run_offline_pipeline_batched(
    cam: CameraParams,
    images_u8,                # [B,T,H,W] uint8
    depths_m,                 # [B,T,H,W] float32
    opts: TrackingOptions,
    device="cuda",
    timings: dict | None = None,
    stats: dict | None = None,
    **kw,                     # build_offline_pipeline options
) -> tuple[MapState, OfflineOut]:
    """B sequences of T frames as folded lanes (BASELINE config 5): one
    ``lanes=B`` run over the B*T frames concatenated, with the JAX
    package's defaults (``kf_capacity`` per lane from
    ``default_lane_kf_capacity(T)``). Chunks count frames and pairs of the
    folded axis, whatever B. Returns per-lane (MapState [B,...], OfflineOut
    [B,T,...]) split out of the merged tables; lane b equals a single run
    of its frames."""
    dev = torch.device(device)
    images = torch.as_tensor(images_u8).to(dev)
    depths = torch.as_tensor(depths_m).to(dev, torch.float32)
    B, T = images.shape[:2]
    K = kw.setdefault("kf_capacity", default_lane_kf_capacity(T))
    run = build_offline_pipeline(opts, lanes=B, **kw)
    flat = lambda x: x.reshape(B * T, *x.shape[2:])
    ms, out = run(cam, flat(images), flat(depths), timings, stats)
    lane = lambda x: x.reshape(B, T, *x.shape[1:])
    n_lm = out.n_landmarks.reshape(B)
    out = OfflineOut(
        pose=lane(out.pose), tracked=lane(out.tracked),
        n_matches=lane(out.n_matches), n_inliers=lane(out.n_inliers),
        parallax=lane(out.parallax), is_keyframe=lane(out.is_keyframe),
        n_keyframes=out.n_keyframes.reshape(B), n_landmarks=n_lm)
    N = ms.kf_desc.shape[1]
    return split_merged_lanes(ms, B, K, N, T, n_lm), out

