"""Throughput mode: many sequences mapped at once, spread over the ranks of
a process group (counterpart of ``visionx_slam_tpu/parallel/batch.py``,
BASELINE.json config 5).

The JAX package shards the lane axis of a batch over a device mesh with
``shard_map`` and sums fleet statistics with one ``psum``. Here a rank is a
process with one device: a card under ``nccl`` (one card per rank: NCCL
refuses two ranks on one card) or the CPU under ``gloo``. A ``Mesh`` names
the group, the rank, the world size and the rank's device; rank r of W runs
lanes [r*B/W, (r+1)*B/W) of a batch of B and returns its own lanes (the
counterpart of out_specs ``P(axis)``: each device holds its shard), and the
fleet totals ride ONE ``all_reduce(SUM)`` of one int64 tensor. Lanes are
independent and draw from generators seeded by their global lane index, so
a lane's result does not depend on which rank runs it or on the world size.

``slam_step`` is the fused mapping step of one lane: match against the
newest keyframe -> PnP RANSAC -> keyframe insert -> depth and triangulated
landmarks -> windowed local BA. The map ops are single-map and update the
tables in place (``tracking/mapstate.py``), so a step changes the lanes'
maps it is given: clone a fleet to run it twice. The per-rank loop over
lanes is a host loop, as ``run_scan_pipeline_batched``'s.

Nothing on the card's path degrades: ``nccl`` with fewer cards than ranks,
a failed ``init_process_group`` or a card that is not there raises; the
card path never becomes ``gloo`` on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..models import matching
from ..models.estimation import pnp_ransac
from ..models.local_ba import BAOptions, local_ba
from ..ops.camera import CameraParams
from ..ops.se3 import Pose, identity_pose, se3_matrix
from ..tracking import mapstate as msl
from ..tracking import stages
from ..tracking.mapstate import FREE, MapState
from ..tracking.stages import FrameObs


class Mesh(NamedTuple):
    """One rank's view of the process group that lanes are spread over."""

    group: dist.ProcessGroup | None   # None: a world of one, no group
    rank: int
    world_size: int
    device: torch.device
    axis: str = "seq"

    def __repr__(self) -> str:
        if self.group is None:
            return (f"Mesh(world of one, no process group, device={self.device}, "
                    f"axis={self.axis!r})")
        return (f"Mesh(rank {self.rank} of {self.world_size}, "
                f"backend={dist.get_backend(self.group)}, device={self.device}, "
                f"axis={self.axis!r})")

    def lanes(self, n_lanes: int) -> slice:
        """This rank's lanes of a batch of ``n_lanes``."""
        if n_lanes % self.world_size:
            raise ValueError(f"{n_lanes} lanes do not split over "
                             f"{self.world_size} ranks")
        per = n_lanes // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, in place (a world of one: ``x``)."""
        if self.group is not None:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x


def init_group(store_path: str, rank: int, world_size: int,
               device: str = "cuda") -> None:
    """Initialize the default process group of ``world_size`` ranks from a
    ``FileStore`` at ``store_path`` (a file in a directory every rank can
    see, unused by any other run: no port, no network). ``device`` "cuda":
    ``nccl``, rank r on card r; "cpu": ``gloo``."""
    kind = torch.device(device).type
    if kind == "cuda":
        n_cards = torch.cuda.device_count()
        if n_cards < world_size:
            raise RuntimeError(f"nccl needs one card per rank: {world_size} "
                               f"ranks, {n_cards} cards")
        torch.cuda.set_device(rank)
        backend = "nccl"
    elif kind == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no backend for device {device!r}")
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)


def make_mesh(n_devices: int | None = None, axis: str = "seq",
              device: str | None = None) -> Mesh:
    """The mesh of the initialized default group (its backend decides the
    device: ``nccl`` the rank's card, ``gloo`` the CPU); with no group, a
    world of one on ``device`` (default the card). ``n_devices`` (the
    group's world size: one device per rank) and ``device``, when given,
    must agree with the group."""
    if dist.is_available() and dist.is_initialized():
        backend = dist.get_backend()
        dev = (torch.device("cuda", torch.cuda.current_device())
               if backend == "nccl" else torch.device("cpu"))
        mesh = Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                    dev, axis)
    else:
        dev = torch.device(device or "cuda")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        mesh = Mesh(None, 0, 1, dev, axis)
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"the group runs on {mesh.device}, not {device}")
    if n_devices is not None and n_devices != mesh.world_size:
        raise ValueError(f"asked for {n_devices} ranks, the group has "
                         f"{mesh.world_size}")
    return mesh


def lane_generators(seed: int, lanes, device) -> list[torch.Generator]:
    """One generator per lane, seeded from (seed, global lane index): the
    counterpart of ``jax.random.split(PRNGKey(seed), n)`` (other bits)."""
    return [torch.Generator(device=device).manual_seed((seed << 32) + int(b))
            for b in lanes]


def slam_step(
    ms: MapState,
    obs: FrameObs,
    frame_id,
    cam: CameraParams,
    gen: torch.Generator | None,
    n_hypotheses: int = 64,
    ba_opts: BAOptions = BAOptions(max_iterations=2),
    sample_idx: torch.Tensor | None = None,
) -> tuple[MapState, torch.Tensor, dict]:
    """One fused mapping step of one lane: track ``obs`` against the
    newest keyframe, insert it as a keyframe (its pose from PnP, else the
    previous keyframe's), grow the map, run windowed BA. Updates ``ms`` in
    place; returns (state, T_cw [4,4], stats: ``inliers``, ``matches``,
    ``ba_cost``). ``sample_idx`` [H,6]: injected minimal sets (tests).

    PnP draws 6-point DLT hypotheses, with no depth, as the JAX step does
    (its ``pnp_ransac`` call passes no ``depth_curr``)."""
    slots, svalid = msl.window_slots(ms, 1)
    slot = int(slots[0])
    m = matching.match_frames(ms.kf_desc[slot], ms.kf_fvalid[slot] & svalid[0],
                              obs.desc, obs.valid)
    pts3d, pts2d, valid = stages.pnp_correspondences(ms, slot, obs, m)
    sol = pnp_ransac(cam, pts3d[None], pts2d[None], valid[None], gen, 2.0,
                     n_hypotheses, 5,
                     sample_idx=None if sample_idx is None else sample_idx[None])
    # fall back to the previous keyframe pose when PnP is degenerate
    prev = msl.map_pose(ms, slot)
    use = sol.ok[0] & (sol.n_inliers[0] >= 4)
    pose = Pose(torch.where(use, sol.pose.q[0], prev.q),
                torch.where(use, sol.pose.t[0], prev.t))

    N = ms.n_features
    ms, new_slot = msl.insert_keyframe(
        ms, frame_id, pose, obs.px, obs.desc, obs.valid,
        torch.full((N,), FREE, dtype=torch.int32, device=obs.px.device),
        obs.depth, fresh_links=True)
    ms = stages.depth_landmarks(ms, cam, new_slot, pose)
    ms = stages.triangulate_pair(ms, cam, slot, new_slot, 1.0, 5.0)
    ms, ba = local_ba(ms, cam, ba_opts)
    stats = {"inliers": sol.n_inliers[0],
             "matches": m.valid.sum().to(torch.int32),
             "ba_cost": ba.final_cost}
    return ms, se3_matrix(pose), stats


def batched_slam_step(mesh: Mesh, cam: CameraParams, **step_kw):
    """The step over this rank's lanes: returns f(mss [B_local,...], obss,
    fids [B_local], gens: B_local generators) -> (mss, poses
    [B_local,4,4], fleet), where ``fleet`` holds ``total_inliers`` and
    ``total_matches`` summed over every rank's lanes by one all_reduce."""

    def step(mss: MapState, obss: FrameObs, fids, gens):
        outs = [slam_step(ms, obs, fids[b], cam, gens[b], **step_kw)
                for b, (ms, obs) in enumerate(zip(unstack_states(mss),
                                                  unstack_obs(obss)))]
        lanes, poses, stats = zip(*outs)
        totals = torch.stack([
            torch.stack([s["inliers"] for s in stats]).sum(),
            torch.stack([s["matches"] for s in stats]).sum()]).to(torch.int64)
        mesh.all_sum(totals)
        fleet = {"total_inliers": totals[0], "total_matches": totals[1]}
        return stack_states(list(lanes)), torch.stack(poses), fleet

    return step


def sharded_offline_pipeline(mesh: Mesh, cam: CameraParams, opts,
                             refine_iterations: int = 1, **kw):
    """The batched offline pipeline over the mesh (BASELINE config 5): f(
    images [B,T,H,W] u8, depths [B,T,H,W] f32) runs this rank's lanes as
    folded lanes (``run_offline_pipeline_batched``, ``kw`` its options) and
    returns (MapState [B_local,...], OfflineOut [B_local,...], fleet):
    ``fleet`` holds ``total_tracked``, ``total_keyframes`` and
    ``total_landmarks`` over every rank (one all_reduce) and this rank's
    ``lane_offset``. B must be a multiple of the world size."""
    from ..tracking.offline_pipeline import run_offline_pipeline_batched

    def run(images, depths):
        sl = mesh.lanes(images.shape[0])
        ms, out = run_offline_pipeline_batched(
            cam, images[sl], depths[sl], opts, device=mesh.device,
            refine_iterations=refine_iterations, **kw)
        totals = torch.stack([out.tracked.sum(), out.n_keyframes.sum(),
                              out.n_landmarks.sum()]).to(torch.int64)
        mesh.all_sum(totals)
        fleet = {"total_tracked": totals[0], "total_keyframes": totals[1],
                 "total_landmarks": totals[2], "lane_offset": sl.start}
        return ms, out, fleet

    return run


def _stack(items: list):
    return type(items[0])(*(torch.stack(x) for x in zip(*items)))


def _unstack(nt) -> list:
    return [type(nt)(*(x[b] for x in nt)) for b in range(nt[0].shape[0])]


def stack_states(states: list[MapState]) -> MapState:
    """Lane maps -> one MapState with a leading [B] axis on every field."""
    return _stack(states)


def stack_obs(obs: list[FrameObs]) -> FrameObs:
    return _stack(obs)


def unstack_states(ms: MapState) -> list[MapState]:
    """The inverse of ``stack_states``: views of each lane's fields."""
    return _unstack(ms)


def unstack_obs(obs: FrameObs) -> list[FrameObs]:
    return _unstack(obs)


def _lane_map(cam, px, desc, valid, depth, n_features, kf_capacity,
              lm_capacity, device) -> MapState:
    """A lane's map: one keyframe at the identity (slot 0, frame 0) with a
    landmark at every valid feature with depth."""
    ms = msl.empty_map(kf_capacity=kf_capacity, lm_capacity=lm_capacity,
                       n_features=n_features, device=device)
    ident = identity_pose(device=device)
    ms, slot = msl.insert_keyframe(
        ms, 0, ident, px, desc, valid,
        torch.full((n_features,), FREE, dtype=torch.int32, device=device),
        depth, fresh_links=True, slot=0)
    return stages.depth_landmarks(ms, cam, slot, ident)


def make_rendered_fleet(
    cam: CameraParams, dataset_root: str, n_seq: int,
    n_features: int = 1024, kf_capacity: int = 8,
    lm_capacity: int = 1 << 14,
    sequence: str = "rgbd_dataset_freiburg3_synthetic",
    device="cuda",
):
    """A fleet from rendered 640x480 frames on disk (TUM layout) through
    the port's extractor (K1, 8 frames a launch): lane b's keyframe is
    frame b (depth-backprojected landmarks from its ORB features), its
    observation frame b+1. Returns (states [D,...], obs [D,...], frame_ids
    [D], gens, gt_rel) where ``gt_rel`` is the list of ground-truth [4,4]
    relative transforms T_{c1<-c0} each lane's PnP must recover."""
    from ..data import tum
    from ..models.orb_torch import orb_extract
    from ..utils.rotation import quat_xyzw_to_matrix

    dev = torch.device(device)
    ds = tum.TumDataset(dataset_root, sequence)
    if not ds.load() or len(ds.entries) < n_seq + 1:
        raise ValueError(f"{dataset_root}/{sequence}: fewer than {n_seq + 1} frames")
    entries = ds.entries[: n_seq + 1]
    grays = torch.as_tensor(np.stack([tum.load_rgb_gray(e.rgb_path)
                                      for e in entries])).to(dev)
    depth_img = torch.as_tensor(np.stack([tum.load_depth_m(e.depth_path)
                                          for e in entries])).to(dev)
    feats = [orb_extract(grays[i:i + 8], n_slots=n_features)
             for i in range(0, n_seq + 1, 8)]
    px, resp, desc, valid = (torch.cat(x) for x in zip(*feats))
    depth = stages.sample_depth_image(depth_img, px, valid)

    def w_mat(e):                  # T_wc (camera-to-world, TUM ground truth)
        T = np.eye(4)
        T[:3, :3] = quat_xyzw_to_matrix(e.gt_q)
        T[:3, 3] = e.gt_t
        return T

    states, obss, gt_rel = [], [], []
    for b in range(n_seq):
        states.append(_lane_map(cam, px[b], desc[b], valid[b], depth[b],
                                n_features, kf_capacity, lm_capacity, dev))
        obss.append(FrameObs(px=px[b + 1], response=resp[b + 1],
                             desc=desc[b + 1], valid=valid[b + 1],
                             depth=depth[b + 1]))
        # world = lane keyframe's camera frame: T_cw of the obs frame is
        # the ground-truth relative transform c_{b+1} <- c_b
        gt_rel.append(np.linalg.inv(w_mat(entries[b + 1])) @ w_mat(entries[b]))
    fids = torch.ones(n_seq, dtype=torch.int32, device=dev)
    return (stack_states(states), stack_obs(obss), fids,
            lane_generators(7, range(n_seq), dev), gt_rel)


def make_correlated_fleet(
    cam: CameraParams, n_seq: int, n_features: int = 64, seed: int = 0,
    kf_capacity: int = 8, lm_capacity: int = 256, device="cuda",
):
    """Per-sequence synthetic scenes with geometrically consistent second
    frames: each lane's observation is its keyframe's landmarks
    re-projected under a known small motion with identical descriptors, so
    matching and PnP succeed on every lane. The numpy draws are the JAX
    fleet's (``default_rng(seed + 1000 * i)``). Returns (states [D,...],
    obs [D,...], frame_ids [D], gens, gt_poses: (R, t) per lane, numpy)."""
    from ..ops.camera import backproject, project_pinhole
    from ..ops.se3 import matrix_to_quat

    dev = torch.device(device)
    N = n_features
    f32 = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a)).to(dev, dt)
    states, obss, gts = [], [], []
    for i in range(n_seq):
        rng = np.random.default_rng(seed + 1000 * i)
        # keyframe at identity observing a random 3D cloud in view
        px = f32(np.stack([rng.uniform(4, 2 * cam.cx - 4, N),
                           rng.uniform(4, 2 * cam.cy - 4, N)], -1))
        depth = f32(rng.uniform(1.0, 4.0, N))
        desc = f32(rng.integers(0, 256, (N, 32)), torch.uint8)
        valid = torch.ones(N, dtype=torch.bool, device=dev)
        states.append(_lane_map(cam, px, desc, valid, depth, N, kf_capacity,
                                lm_capacity, dev))

        # second frame: small known motion; observations are the exact
        # projections of the same points with the same descriptors
        angle = 0.01 * (1 + i % 3)
        ca, sa = np.cos(angle), np.sin(angle)
        R = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]], np.float32)
        t = np.array([0.02 * (i % 4 + 1), -0.01, 0.015], np.float32)
        pose1 = Pose(matrix_to_quat(f32(R)), f32(t))
        pw = backproject(cam, px, depth)           # world (kf at identity)
        uv, ok, pc = project_pinhole(cam, pose1, pw)
        obss.append(FrameObs(px=uv, response=torch.zeros(N, device=dev),
                             desc=desc, valid=valid & ok,
                             depth=torch.where(ok, pc[..., 2], 0.0)))
        gts.append((R, t))
    fids = torch.ones(n_seq, dtype=torch.int32, device=dev)
    return (stack_states(states), stack_obs(obss), fids,
            lane_generators(seed, range(n_seq), dev), gts)
