"""The port's file sinks against the JAX package's on the same arrays: PLY
text equal byte for byte, the feature overlay equal pixel for pixel (and the
PNG the port writes reads back through cv2 as what the JAX package's
writer leaves), the snapshot exporter and the trajectory reader equal."""

import cv2
import numpy as np
import pytest

from visionx_slam_tpu.eval import export as jexport
from visionx_slam_tpu.eval import overlay as joverlay

from visionx_slam_torch.eval import export as texport
from visionx_slam_torch.eval import overlay as toverlay


def _map_arrays(rng, K=6, N=40, L=300):
    lm_pos = rng.normal(size=(3, L)).astype(np.float32) * 3
    lm_pos[:, 5] = np.nan                       # dropped by the exporters
    q = rng.normal(size=(K, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    kf_id = np.array([0, 3, -1, 9, 12, -1], np.int32)
    return dict(lm_pos=lm_pos, lm_alive=rng.random(L) < 0.7, kf_q=q,
                kf_t=rng.normal(size=(K, 3)).astype(np.float32), kf_id=kf_id)


@pytest.mark.parametrize("colors", [False, True])
def test_write_ply_text_equal(tmp_path, colors):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(50, 3)) * 10
    cols = rng.integers(0, 256, (50, 3)) if colors else None
    texport.write_ply(str(tmp_path / "t.ply"), pts, cols)
    jexport.write_ply(str(tmp_path / "j.ply"), pts, cols)
    assert (tmp_path / "t.ply").read_text() == (tmp_path / "j.ply").read_text()


def test_map_and_snapshot_ply_equal(tmp_path):
    m = _map_arrays(np.random.default_rng(2))
    centers = np.random.default_rng(3).normal(size=(4, 3))
    for max_points in (200_000, 50):
        n_t = texport.export_map_ply(str(tmp_path / "t.ply"), m["lm_pos"],
                                     m["lm_alive"], centers, max_points)
        n_j = jexport.export_map_ply(str(tmp_path / "j.ply"), m["lm_pos"],
                                     m["lm_alive"], centers, max_points)
        assert n_t == n_j > 0
        assert (tmp_path / "t.ply").read_text() == (tmp_path / "j.ply").read_text()
    snap = str(tmp_path / "map_snapshot.npz")
    np.savez_compressed(snap, **m)
    n_t = texport.export_snapshot_ply(snap, str(tmp_path / "ts.ply"))
    n_j = jexport.export_snapshot_ply(snap, str(tmp_path / "js.ply"))
    assert n_t == n_j == int((m["lm_alive"] & np.isfinite(m["lm_pos"]).all(0)).sum()) + 4
    # keyframe centres pass through a quaternion: equal to the 6 decimals
    # of the file but for a last-digit rounding (1e-6)
    a = np.loadtxt(str(tmp_path / "ts.ply"), skiprows=10)
    b = np.loadtxt(str(tmp_path / "js.ply"), skiprows=10)
    np.testing.assert_allclose(a, b, rtol=0, atol=1.5e-6)
    for q in m["kf_q"]:
        # the JAX package's stays in the snapshot's float32: 1e-6
        np.testing.assert_allclose(texport._quat_to_R(q), jexport._quat_to_R(q),
                                   atol=1e-6)


def test_read_tum_trajectory_positions_equal(tmp_path):
    p = tmp_path / "trajectory.txt"
    p.write_text("# estimated trajectory\n\n1.5 0.1 0.2 0.3 0 0 0 1\n"
                 "2.5 -1 2 3.25 0 0 0 1\n")
    (ts_t, xyz_t), (ts_j, xyz_j) = (texport.read_tum_trajectory(str(p)),
                                    jexport.read_tum_trajectory(str(p)))
    np.testing.assert_array_equal(ts_t, ts_j)
    np.testing.assert_array_equal(xyz_t, xyz_j)


def test_plot_trajectory_writes_a_figure_or_raises_import_error(tmp_path):
    p = tmp_path / "trajectory.txt"
    p.write_text("1.5 0.1 0.2 0.3 0 0 0 1\n2.5 -1 2 3.25 0 0 0 1\n")
    out = str(tmp_path / "traj.png")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            texport.plot_trajectory(str(p), out)
        return
    assert texport.plot_trajectory(str(p), out, gt_path=str(p)) == out
    assert cv2.imread(out) is not None


@pytest.mark.parametrize("with_landmarks", [False, True])
def test_overlay_image_equal(tmp_path, with_landmarks):
    rng = np.random.default_rng(4)
    gray = rng.integers(0, 256, (120, 160), dtype=np.uint8)
    px = rng.uniform(-4, 164, (80, 2)).astype(np.float32)   # some off the image
    valid = rng.random(80) < 0.8
    has_lm = rng.random(80) < 0.5 if with_landmarks else None
    img_t = toverlay.draw_feature_overlay(gray, px, valid, has_lm)
    img_j = joverlay.draw_feature_overlay(gray, px, valid, has_lm)
    np.testing.assert_array_equal(img_t, img_j)
    assert (img_t == np.array(toverlay.FEATURE_COLOR, np.uint8)).all(-1).any()
    toverlay.write_png(str(tmp_path / "t.png"), img_t)
    joverlay.write_png(str(tmp_path / "j.png"), img_j)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "t.png")),
                                  cv2.imread(str(tmp_path / "j.png")))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "t.png")), img_t)
