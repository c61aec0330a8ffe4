"""The multi-device module on two ``gloo`` ranks on the CPU (two
processes joined by a FileStore, one thread each) against the unsharded
runs of the same lanes in this process:

- ``batched_slam_step`` over a 4-lane correlated fleet equals the loop of
  ``slam_step`` over the same lanes bit for bit; its totals are the sums.
- ``sharded_offline_pipeline`` over 4 lanes (rolled copies of the dry
  run's 8-frame loop, so rolled starts join up) equals
  ``run_offline_pipeline_batched`` of the 4 lanes: tracked, keyframes and
  the maps' links and counts equal, poses within 1e-5 (on the CPU they are
  bit-equal; a folded lane equals a single run); each total is the sum.
  8 frames a lane, not 16: at 16 the 4-lane reference alone took 62 s on
  one CPU thread (extraction 56 s).
"""

import os
import subprocess
import sys

import numpy as np
import torch

from visionx_slam_torch.data import synthetic
from visionx_slam_torch.models.local_ba import BAOptions
from visionx_slam_torch.ops.camera import make_camera
from visionx_slam_torch.parallel import batch as TB
from visionx_slam_torch.tracking.offline_pipeline import run_offline_pipeline_batched
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import SINGLE_THREAD_ENV, sequence, t, to_np

CAM = (100.0, 100.0, 32.0, 24.0)   # the dry run's camera
N = 64


_RANK = r"""
import sys, torch
from visionx_slam_torch.models.local_ba import BAOptions
from visionx_slam_torch.ops.camera import make_camera
from visionx_slam_torch.parallel import batch as pb
from visionx_slam_torch.utils.config import TrackingOptions
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
pb.init_group(tmp + "/store", rank, world, "cpu")
mesh = pb.make_mesh(world, device="cpu")
cam = make_camera(100.0, 100.0, 32.0, 24.0)
mss, obss, fids, gens, _ = pb.make_correlated_fleet(cam, 4, 64, seed=0, device="cpu")
sl = mesh.lanes(4)
pick = lambda nt: type(nt)(*(x[sl] for x in nt))
step = pb.batched_slam_step(mesh, cam, n_hypotheses=16, ba_opts=BAOptions(max_iterations=2))
ms2, poses, fleet = step(pick(mss), pick(obss), fids[sl], gens[sl])
data = torch.load(tmp + "/lanes.pt")
cam_r = make_camera(*data["cam"])
f = pb.sharded_offline_pipeline(mesh, cam_r, TrackingOptions(), kf_capacity=4,
                                extract_chunk=2, pair_chunk=4)
ms_o, out_o, fleet_o = f(data["g"], data["d"])
torch.save({"repr": repr(mesh), "lanes": (sl.start, sl.stop), "ms": tuple(ms2),
            "poses": poses, "fleet": fleet, "out": tuple(out_o),
            "ms_o": tuple(ms_o), "fleet_o": fleet_o}, f"{tmp}/rank{rank}.pt")
torch.distributed.destroy_process_group()
"""


def test_two_gloo_ranks_equal_the_unsharded_runs(tmp_path):
    T, B = 8, 4
    grays, depths, _ = sequence(T, 11, T)       # one loop: rolled starts join up
    g = np.stack([np.roll(grays, b, axis=0) for b in range(B)])
    d = np.stack([np.roll(depths, b, axis=0) for b in range(B)])
    torch.save({"g": t(g), "d": t(d),
                "cam": (synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)},
               tmp_path / "lanes.pt")
    env = {**os.environ, **SINGLE_THREAD_ENV}
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), "2", str(tmp_path)],
                              env=env, cwd=os.path.dirname(os.path.dirname(__file__)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]

    # the unsharded runs, meanwhile
    cam = make_camera(*CAM)
    mss, obss, fids, gens, _ = TB.make_correlated_fleet(cam, B, N, seed=0, device="cpu")
    kw = dict(n_hypotheses=16, ba_opts=BAOptions(max_iterations=2))
    ref = [TB.slam_step(ms, obs, fids[b], cam, gens[b], **kw) for b, (ms, obs)
           in enumerate(zip(TB.unstack_states(mss), TB.unstack_obs(obss)))]
    cam_r = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    ms_u, out_u = run_offline_pipeline_batched(cam_r, g, d, TrackingOptions(),
                                               device="cpu", kf_capacity=4,
                                               extract_chunk=2, pair_chunk=4)

    for p in procs:
        log = p.communicate(timeout=240)[0].decode()
        assert p.returncode == 0, log
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    assert "rank 0 of 2, backend=gloo" in ranks[0]["repr"]
    assert [r["lanes"] for r in ranks] == [(0, 2), (2, 4)]

    # the fused step: bit for bit, totals the host sums
    poses = torch.cat([r["poses"] for r in ranks])
    assert torch.equal(poses, torch.stack([x[1] for x in ref]))
    ms_s = [torch.cat(x) for x in zip(*(r["ms"] for r in ranks))]
    assert all(torch.equal(a, b) for a, b in
               zip(ms_s, TB.stack_states([x[0] for x in ref])))
    for r in ranks:
        assert int(r["fleet"]["total_inliers"]) == sum(int(x[2]["inliers"]) for x in ref)
        assert int(r["fleet"]["total_matches"]) == sum(int(x[2]["matches"]) for x in ref)

    # the sharded offline pipeline
    out_s = type(out_u)(*(torch.cat(x) for x in zip(*(r["out"] for r in ranks))))
    assert torch.equal(out_s.tracked, out_u.tracked) and bool(out_u.tracked.all())
    assert torch.equal(out_s.is_keyframe, out_u.is_keyframe)
    assert torch.equal(out_s.n_keyframes, out_u.n_keyframes)
    np.testing.assert_allclose(to_np(out_s.pose), to_np(out_u.pose), rtol=0, atol=1e-5)
    # the lanes' maps (a dead keyframe slot keeps whatever the merged table
    # held there, which depends on the neighbouring lanes)
    ms_o = type(ms_u)(*(torch.cat(x) for x in zip(*(r["ms_o"] for r in ranks))))
    for f in ("kf_id", "kf_feat_lm", "lm_alive", "lm_obs", "next_kf", "next_lm"):
        assert torch.equal(getattr(ms_o, f), getattr(ms_u, f)), f
    np.testing.assert_allclose(to_np(ms_o.kf_t), to_np(ms_u.kf_t), rtol=0, atol=1e-5)
    for r in ranks:
        fl = r["fleet_o"]
        assert int(fl["total_tracked"]) == int(out_u.tracked.sum()) == B * T
        assert int(fl["total_keyframes"]) == int(out_u.n_keyframes.sum())
        assert int(fl["total_landmarks"]) == int(out_u.n_landmarks.sum())
    assert [r["fleet_o"]["lane_offset"] for r in ranks] == [0, 2]
