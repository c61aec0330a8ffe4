"""The Python loader's decode-ahead (``data/prefetch.py``): its frames are
the two loaders' bit for bit and in order at any window; a worker's error
reaches the consumer at its frame and ``System.run()`` leaves no decode
thread behind; a window decoded while the consumer held a frame counts as
found ready. Nothing here rests on a timing threshold."""

import os
import sys
import threading
import time

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per test process)
from visionx_slam_torch.data import png, tum
from visionx_slam_torch.data.prefetch import THREAD_PREFIX, PythonPrefetcher
from visionx_slam_torch.system.system import System
from visionx_slam_torch.utils.config import SystemConfig

SEQ = "rgbd_dataset_freiburg1_desk"
T, H, W = 9, 48, 64


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """(root, rgb paths, depth paths, grays, depths_m): a TUM directory of
    T colour and 16-bit depth PNGs with their lists and ground truth."""
    root = tmp_path_factory.mktemp("tum")
    d = root / SEQ
    (d / "rgb").mkdir(parents=True)
    (d / "depth").mkdir()
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8)
    units = rng.integers(0, 65536, (T, H, W), dtype=np.uint16)
    stamps = [f"{1.0 + i / 30:.6f}" for i in range(T)]
    rgb_paths, depth_paths = [], []
    for i, ts in enumerate(stamps):
        rgb_paths.append(str(d / "rgb" / f"{ts}.png"))
        depth_paths.append(str(d / "depth" / f"{ts}.png"))
        png.write_png(rgb_paths[-1], rgb[i])
        png.write_png(depth_paths[-1], units[i])
    for name, sub in (("rgb.txt", "rgb"), ("depth.txt", "depth")):
        (d / name).write_text("".join(f"{ts} {sub}/{ts}.png\n" for ts in stamps))
    (d / "groundtruth.txt").write_text(
        "".join(f"{ts} 0 0 0 0 0 0 1\n" for ts in stamps))
    grays = np.stack([png.rgb_to_gray(x) for x in rgb])
    return (str(root), rgb_paths, depth_paths, grays,
            units.astype(np.float32) / tum.DEPTH_SCALE)


def _alive():
    return [t for t in threading.enumerate() if t.name.startswith(THREAD_PREFIX)]


@pytest.mark.parametrize("queue_depth", [1, 4, T + 5])
def test_frames_are_the_written_arrays_in_order(seq, queue_depth):
    _, rgb_paths, depth_paths, grays, depths = seq
    pf = PythonPrefetcher(rgb_paths, depth_paths, queue_depth=queue_depth)
    try:
        got = list(pf)
    finally:
        pf.close()
    assert len(got) == T
    for i, (g, d) in enumerate(got):
        assert g.dtype == np.uint8 and d.dtype == np.float32
        np.testing.assert_array_equal(g, grays[i])
        np.testing.assert_array_equal(d, depths[i])
        np.testing.assert_array_equal(g, tum.load_rgb_gray(rgb_paths[i]))
        np.testing.assert_array_equal(d, tum.load_depth_m(depth_paths[i]))
    assert 0 <= pf.ready <= T and pf.decode_seconds() > 0
    assert not _alive()


def test_many_workers_switching_often_keep_the_order(seq):
    _, rgb_paths, depth_paths, grays, depths = seq
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pf = PythonPrefetcher(rgb_paths * 3, depth_paths * 3, queue_depth=6,
                              n_threads=8)
        try:
            got = list(pf)
        finally:
            pf.close()
    finally:
        sys.setswitchinterval(interval)
    np.testing.assert_array_equal(np.stack([g for g, _ in got]),
                                  np.concatenate([grays] * 3))
    np.testing.assert_array_equal(np.stack([d for _, d in got]),
                                  np.concatenate([depths] * 3))
    assert not _alive()


def test_a_missing_file_raises_from_run_and_no_worker_outlives_it(seq, tmp_path):
    root = tmp_path / "copy"
    src = os.path.join(seq[0], SEQ)
    dst = root / SEQ
    for sub in ("rgb", "depth"):
        (dst / sub).mkdir(parents=True)
        for f in os.listdir(os.path.join(src, sub)):
            os.link(os.path.join(src, sub, f), dst / sub / f)
    for f in ("rgb.txt", "depth.txt", "groundtruth.txt"):
        os.link(os.path.join(src, f), dst / f)
    (dst / "depth" / sorted(os.listdir(dst / "depth"))[3]).unlink()
    cfg = SystemConfig(dataset_dir=str(root), sequence=SEQ,
                       output_dir=str(tmp_path / "out"), pipeline="scan",
                       loader="python", device="cpu")
    with pytest.raises(FileNotFoundError):
        System(cfg).run()
    assert not _alive()


@pytest.mark.parametrize("queue_depth", [2, 5])
def test_a_window_decoded_while_a_frame_is_held_counts_as_ready(seq, queue_depth):
    _, rgb_paths, depth_paths, grays, _ = seq
    pf = PythonPrefetcher(rgb_paths, depth_paths, queue_depth=queue_depth)
    try:
        frames = iter(pf)
        next(frames)
        deadline = time.monotonic() + 60
        while pf.ahead() < queue_depth and time.monotonic() < deadline:
            time.sleep(0.005)
        assert pf.ahead() == queue_depth
        ready = pf.ready
        for i in range(1, queue_depth):
            np.testing.assert_array_equal(next(frames)[0], grays[i])
        assert pf.ready - ready == queue_depth - 1
    finally:
        pf.close()
    assert not _alive()
