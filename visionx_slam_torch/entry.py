"""Entry points of the port's compile-free checks (counterpart of the JAX
package's ``__graft_entry__.py``): the perception front half on one frame,
and the multi-device dry run.

    python -m visionx_slam_torch.entry [--device cpu]
    python -m visionx_slam_torch.entry multichip N [--device cpu]

The second starts N processes (``torch.multiprocessing.spawn``) joined by a
``FileStore`` in a temporary directory: ``nccl`` with one card per rank, or
``gloo`` on the CPU under ``--device cpu``. NCCL does not put two ranks on
one card, so a host with one card runs a world of one.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch


def entry(device: str = "cuda"):
    """(forward, example_args): ORB extraction on a 480x640 frame (kernel
    K1 at B=1), Hamming matching against a reference keyframe's
    descriptors, and PnP RANSAC (6-point DLT, 64 hypotheses, 5 refine
    steps) against that keyframe's landmarks. The inputs are random, made
    with numpy from seed 0 as the JAX package's; ``forward`` returns
    (pose, n_inliers [1], n_valid)."""
    from .models import matching
    from .models.estimation import pnp_ransac
    from .models.orb_torch import orb_extract
    from .ops.camera import make_camera

    dev = torch.device(device)
    cam = make_camera(525.0, 525.0, 319.5, 239.5)

    def forward(gray_u8, ref_desc, ref_valid, ref_landmarks, gen):
        px, _, desc, valid = orb_extract(gray_u8[None])
        m = matching.match_frames(ref_desc, ref_valid, desc[0], valid[0])
        pts2d = px[0][m.idx]
        sol = pnp_ransac(cam, ref_landmarks[None], pts2d[None], m.valid[None],
                         gen, 2.0, 64, 5)
        return sol.pose, sol.n_inliers, valid.sum()

    rng = np.random.default_rng(0)
    on = lambda a: torch.as_tensor(a).to(dev)
    gray = on(rng.integers(0, 255, (480, 640)).astype(np.uint8))
    ref_desc = on(rng.integers(0, 256, (1024, 32)).astype(np.uint8))
    ref_valid = torch.ones(1024, dtype=torch.bool, device=dev)
    ref_lm = on(rng.uniform(-2, 2, (1024, 3)).astype(np.float32))
    gen = torch.Generator(device=dev).manual_seed(0)
    return forward, (gray, ref_desc, ref_valid, ref_lm, gen)


def dryrun_multichip(world_size: int, device: str | None = None) -> dict:
    """One rank's part of the multi-device dry run over a group of
    ``world_size`` ranks (or no group, when it is 1: then on ``device``,
    default the card; with a group on the group's device): (a) one
    ``batched_slam_step`` over a correlated fleet of one lane per rank
    (64 features, camera 100/100/32/24, 16 hypotheses), held to the JAX
    run's bounds; (b) ``sharded_offline_pipeline`` over one rolled copy of
    an 8-frame synthetic loop per rank (``kf_capacity`` 4, chunks 2 and 4):
    every lane tracks every frame within 5 cm. Raises where a check fails;
    returns the fleet totals and this rank's lanes."""
    from .data import synthetic, tum
    from .eval.trajectory import ate_of_run
    from .models.local_ba import BAOptions
    from .ops.camera import make_camera
    from .parallel import batch as pb
    from .utils.config import TrackingOptions

    mesh = pb.make_mesh(world_size, device=device)
    dev = mesh.device
    cam = make_camera(100.0, 100.0, 32.0, 24.0)

    # geometrically consistent scenes: each lane really tracks
    N, D = 64, world_size
    mss, obss, fids, gens, _ = pb.make_correlated_fleet(cam, D, N, seed=0,
                                                        device=dev)
    sl = mesh.lanes(D)
    pick = lambda nt: type(nt)(*(x[sl] for x in nt))
    step = pb.batched_slam_step(mesh, cam, n_hypotheses=16,
                                ba_opts=BAOptions(max_iterations=2))
    _, _, fleet = step(pick(mss), pick(obss), fids[sl], gens[sl])
    inl, mat = int(fleet["total_inliers"]), int(fleet["total_matches"])
    print(f"dryrun step ok: {mesh}, fleet inliers={inl}, matches={mat}",
          flush=True)
    if mat < D * N // 2 or inl < D * N // 4:
        raise RuntimeError(f"the fleet does not track: {mat} matches, "
                           f"{inl} inliers over {D} lanes of {N}")

    # the offline pipeline sharded over the ranks: one loop of Tf frames
    # (rolled lane starts have no motion discontinuity), lane b its copy
    # rolled by b
    Tf = 8
    seq = "rgbd_dataset_freiburg3_synthetic"
    with tempfile.TemporaryDirectory() as root:
        synthetic.generate_sequence(root, sequence=seq, n_frames=Tf, seed=11,
                                    frames_per_loop=Tf)
        ds = tum.TumDataset(root, seq)
        ds.load()
        grays = np.stack([tum.load_rgb_gray(e.rgb_path) for e in ds.entries])
        depths = np.stack([tum.load_depth_m(e.depth_path) for e in ds.entries])
        gts = np.stack([e.gt_t for e in ds.entries])
    cam_r = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    g = np.stack([np.roll(grays, b, axis=0) for b in range(D)])
    d = np.stack([np.roll(depths, b, axis=0) for b in range(D)])
    f = pb.sharded_offline_pipeline(mesh, cam_r, TrackingOptions(), kf_capacity=4,
                                    extract_chunk=2, pair_chunk=4,
                                    refine_iterations=1)
    _, out, fleet_o = f(g, d)
    tracked = out.tracked.cpu().numpy()            # [D_local, Tf]
    kf_per_lane = out.n_keyframes.cpu().numpy()
    if not (tracked.sum(1) == Tf).all() or int(fleet_o["total_tracked"]) != D * Tf:
        raise RuntimeError(f"lanes lost frames: {tracked.sum(1).tolist()}, fleet "
                           f"{int(fleet_o['total_tracked'])}/{D * Tf}")
    if not (kf_per_lane >= 2).all():
        raise RuntimeError(f"keyframes per lane {kf_per_lane.tolist()}")
    pose = out.pose.cpu().numpy()
    lane_ate = [ate_of_run(pose[i], tracked[i], np.roll(gts, b, axis=0))[0]
                for i, b in enumerate(range(sl.start, sl.stop))]
    res = {"world_size": D, "rank": mesh.rank, "lanes": [sl.start, sl.stop],
           "fleet_inliers": inl, "fleet_matches": mat,
           "fleet_tracked": int(fleet_o["total_tracked"]),
           "fleet_keyframes": int(fleet_o["total_keyframes"]),
           "fleet_landmarks": int(fleet_o["total_landmarks"]),
           "lane_tracked": tracked.sum(1).tolist(), "lane_ate_m": lane_ate}
    print(f"dryrun_multichip ok: {mesh}, sharded-offline fleet: "
          f"tracked={res['fleet_tracked']}/{D * Tf}, "
          f"keyframes={res['fleet_keyframes']}, landmarks={res['fleet_landmarks']}, "
          f"lanes {sl.start}-{sl.stop - 1} ate_m={[round(a, 4) for a in lane_ate]}",
          flush=True)
    if not all(np.isfinite(a) and a < 0.05 for a in lane_ate):
        raise RuntimeError(f"lane ATE over 5 cm: {lane_ate}")
    return res


def _rank_main(rank: int, world_size: int, device: str, store: str) -> None:
    import torch.distributed as dist

    from .parallel.batch import init_group

    init_group(store, rank, world_size, device)
    try:
        dryrun_multichip(world_size, device)
    finally:
        dist.destroy_process_group()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", choices=["multichip"])
    ap.add_argument("world_size", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    if args.mode == "multichip":
        with tempfile.TemporaryDirectory() as tmp:
            torch.multiprocessing.spawn(
                _rank_main, args=(args.world_size, args.device,
                                  os.path.join(tmp, "store")),
                nprocs=args.world_size, join=True)
        return 0
    fn, example = entry(args.device)
    pose, n_inliers, n_valid = fn(*example)
    print(f"entry ok: pose q {tuple(pose.q.shape)} t {tuple(pose.t.shape)}, "
          f"inliers {int(n_inliers[0])}, valid features {int(n_valid)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
