"""The port's host-side data modules against the JAX package's (and cv2)
on the same files and arrays: the PNG codec (bit for bit, the three formats,
all five scanline filters), the dataset writer and loaders (a sequence the
port writes loads through the JAX package's cv2 loader equal to one the JAX
package writes; the port's loaders and native bindings equal cv2's on a
JAX-written one), association and intrinsics (equal), the degradations
(equal bits on equal generators) and the trajectory functions (1e-9;
quaternions up to sign)."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from visionx_slam_tpu.data import degrade as jdegrade
from visionx_slam_tpu.data import synthetic as jsynthetic
from visionx_slam_tpu.data import tum as jtum
from visionx_slam_tpu.eval import trajectory as jtraj

from visionx_slam_torch.data import degrade as tdegrade
from visionx_slam_torch.data import native_loader as tnative
from visionx_slam_torch.data import png
from visionx_slam_torch.data import synthetic as tsynthetic
from visionx_slam_torch.data import tum as ttum
from visionx_slam_torch.eval import trajectory as ttraj
from visionx_slam_torch.utils.rotation import matrix_to_quat_xyzw, quat_xyzw_to_matrix

SEQ = "rgbd_dataset_freiburg3_synthetic"
N_FRAMES = 4


def _images(rng):
    return {
        "gray8": rng.integers(0, 256, (37, 53), dtype=np.uint8),
        "rgb8": rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
        "gray16": rng.integers(0, 65536, (37, 53), dtype=np.uint16),
    }


def _cv2_read(path):
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return img[..., ::-1] if img.ndim == 3 else img


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_png_codec_matches_cv2(kind, tmp_path):
    img = _images(np.random.default_rng(3))[kind]
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img[..., ::-1] if img.ndim == 3 else img)
    back = png.read_png(path)
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, img)          # cv2 wrote, the port reads
    png.write_png(path, img)
    np.testing.assert_array_equal(_cv2_read(path), img)   # the port wrote
    np.testing.assert_array_equal(png.read_png(path), img)


def _filter_rows(px: np.ndarray, bpp: int, ftype: int) -> bytes:
    """PNG scanlines of ``px`` [H, stride] with one filter type on every
    row (the encoder's side of the spec, per byte, in Python integers)."""
    H, stride = px.shape
    out = bytearray()
    prior = [0] * stride
    for y in range(H):
        row = [int(v) for v in px[y]]
        out.append(ftype)
        for i, v in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) >> 1
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out.append((v - pred) & 255)
        prior = row
    return bytes(out)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_png_reader_undoes_every_filter(kind, ftype, tmp_path):
    """Files encoded here with each scanline filter (and with a mix, one
    type per band of rows) decode to the image, in the port's reader and
    in cv2's."""
    img = _images(np.random.default_rng(4))[kind]
    H, W = img.shape[:2]
    depth, colour, bpp = {"gray8": (8, 0, 1), "rgb8": (8, 2, 3),
                          "gray16": (16, 0, 2)}[kind]
    px = (img.astype(">u2").view(np.uint8) if kind == "gray16" else img).reshape(H, -1)
    if ftype == "mixed":
        # one filter per band; each band's predictor sees the rows above it
        bands = [_filter_rows(px[:y + 1], bpp, (y * 5) // H)[-(1 + px.shape[1]):]
                 for y in range(H)]
        raw = b"".join(bands)
    else:
        raw = _filter_rows(px, bpp, ftype)

    def chunk(kind_, body):
        return (struct.pack(">I", len(body)) + kind_ + body
                + struct.pack(">I", zlib.crc32(kind_ + body)))

    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, colour, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(_cv2_read(path), img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_png_reader_refuses_what_it_does_not_decode(tmp_path):
    path = str(tmp_path / "rgba.png")
    cv2.imwrite(path, np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError):
        png.read_png(path)
    with pytest.raises(FileNotFoundError):
        png.read_png(str(tmp_path / "missing.png"))
    (tmp_path / "junk.png").write_bytes(b"not a png")
    with pytest.raises(ValueError):
        png.read_png(str(tmp_path / "junk.png"))


def test_gray_conversion_equals_cv2():
    rgb = np.random.default_rng(5).integers(0, 256, (64, 80, 3), dtype=np.uint8)
    np.testing.assert_array_equal(png.rgb_to_gray(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))


def test_gray_conversion_equals_cv2_on_every_colour():
    rgb = np.stack(np.meshgrid(*[np.arange(256, dtype=np.uint8)] * 3,
                               indexing="ij"), -1).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(png.rgb_to_gray(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))


# ---------------------------------------------------------------------------
# sequences on disk
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One sequence written by each package with the same arguments."""
    root_j = str(tmp_path_factory.mktemp("seq_jax"))
    root_t = str(tmp_path_factory.mktemp("seq_torch"))
    jsynthetic.generate_sequence(root_j, n_frames=N_FRAMES, seed=9)
    tsynthetic.generate_sequence(root_t, n_frames=N_FRAMES, seed=9)
    return root_j, root_t


def _load(module, root):
    ds = module.TumDataset(root, SEQ)
    assert ds.load()
    return ds


def test_port_written_sequence_loads_through_the_jax_loader(roots):
    root_j, root_t = roots
    ds_j, ds_t = _load(jtum, root_j), _load(jtum, root_t)
    assert len(ds_j.entries) == len(ds_t.entries) == N_FRAMES
    assert ds_j.intrinsics == ds_t.intrinsics
    for a, b in zip(ds_j.entries, ds_t.entries):
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.gt_t, b.gt_t)
        # scipy does not fix a quaternion's sign: compare rotations
        assert min(np.abs(a.gt_q - b.gt_q).max(), np.abs(a.gt_q + b.gt_q).max()) <= 1e-6
        np.testing.assert_array_equal(jtum.load_rgb_gray(a.rgb_path),
                                      jtum.load_rgb_gray(b.rgb_path))
        np.testing.assert_array_equal(jtum.load_depth_m(a.depth_path),
                                      jtum.load_depth_m(b.depth_path))
    for name in ("rgb.txt", "depth.txt"):
        with open(os.path.join(root_j, SEQ, name)) as fa, \
                open(os.path.join(root_t, SEQ, name)) as fb:
            assert fa.read() == fb.read()


def test_port_loaders_equal_cv2_on_a_jax_written_sequence(roots):
    root_j, _ = roots
    ds_j, ds_t = _load(jtum, root_j), _load(ttum, root_j)
    assert ds_t.intrinsics == ttum.Intrinsics(**vars(ds_j.intrinsics))
    g_mem, d_mem, gt_mem = tsynthetic.make_sequence(N_FRAMES, seed=9)
    for i, (a, b) in enumerate(zip(ds_j.entries, ds_t.entries)):
        assert (a.timestamp, a.rgb_path, a.depth_path) == (
            b.timestamp, b.rgb_path, b.depth_path)
        np.testing.assert_array_equal(a.gt_t, b.gt_t)
        np.testing.assert_array_equal(a.gt_q, b.gt_q)
        gray, depth = ttum.load_rgb_gray(b.rgb_path), ttum.load_depth_m(b.depth_path)
        np.testing.assert_array_equal(gray, jtum.load_rgb_gray(a.rgb_path))
        np.testing.assert_array_equal(depth, jtum.load_depth_m(a.depth_path))
        assert gray.dtype == np.uint8 and depth.dtype == np.float32
        # and the in-memory sequence is what a load gives
        np.testing.assert_array_equal(gray, g_mem[i])
        np.testing.assert_array_equal(depth, d_mem[i])
        np.testing.assert_array_equal(b.gt_t, gt_mem[i])


def test_native_bindings_equal_cv2(roots):
    """The port's ctypes bindings over native/libvxs_io.so: gray equal to
    cv2's bit for bit, depth within one float32 rounding (the library
    multiplies by 1/5000 where cv2's path divides), the prefetcher in order
    and complete; a missing file raises."""
    if not tnative.available():
        pytest.skip("native/libvxs_io.so cannot be built here")
    ds = _load(ttum, roots[0])
    rgb = [e.rgb_path for e in ds.entries]
    dep = [e.depth_path for e in ds.entries]
    pf = tnative.NativePrefetcher(rgb, dep, queue_depth=3, n_threads=2)
    frames = list(pf)
    pf.close()
    assert len(frames) == N_FRAMES and pf.decode_seconds() > 0
    for (g, d), e in zip(frames, ds.entries):
        og, od = jtum.load_rgb_gray(e.rgb_path), jtum.load_depth_m(e.depth_path)
        np.testing.assert_array_equal(g, og)
        np.testing.assert_allclose(d, od, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tnative.decode_gray(e.rgb_path), og)
        np.testing.assert_array_equal(tnative.decode_depth(e.depth_path), d)
    with pytest.raises(IOError):
        tnative.decode_gray("/nonexistent/x.png")


def test_fr1_camera_sequence_matches(tmp_path):
    """The distorted (freiburg1) optics: equal rays, frames and files."""
    seq = "rgbd_dataset_freiburg1_synthetic"
    for mod, sub in ((jsynthetic, "j"), (tsynthetic, "t")):
        mod.generate_sequence(str(tmp_path / sub), sequence=seq, n_frames=2,
                              seed=2, camera="fr1")
    ds_j = jtum.TumDataset(str(tmp_path / "j"), seq)
    ds_t = ttum.TumDataset(str(tmp_path / "t"), seq)
    assert ds_j.load() and ds_t.load()
    assert vars(ds_j.intrinsics) == vars(ds_t.intrinsics)
    assert ds_t.intrinsics.k3 == tsynthetic.FR1["k3"] == jsynthetic.FR1["k3"]
    for a, b in zip(ds_j.entries, ds_t.entries):
        np.testing.assert_array_equal(jtum.load_rgb_gray(a.rgb_path),
                                      ttum.load_rgb_gray(b.rgb_path))
        np.testing.assert_array_equal(jtum.load_depth_m(a.depth_path),
                                      ttum.load_depth_m(b.depth_path))


def test_read_list_associate_and_intrinsics_equal(tmp_path):
    rng = np.random.default_rng(6)
    ts = np.sort(rng.uniform(100.0, 110.0, 40))
    (tmp_path / "s").mkdir()
    lists = {}
    for name, jitter, every in (("rgb", 0.0, 1), ("depth", 0.015, 1), ("gt", 0.03, 2)):
        t = (ts + rng.uniform(-jitter, jitter, ts.shape))[::every]
        with open(tmp_path / "s" / f"{name}.txt", "w") as f:
            f.write("# header\n\n")
            for v in t[::-1]:                    # unsorted on disk
                f.write(f"{v:.6f} " + (f"{name}/{v:.6f}.png\n" if name != "gt"
                        else " ".join(f"{x:.4f}" for x in rng.normal(size=7)) + "\n"))
            f.write("bad\n")
        lists[name] = str(tmp_path / "s" / f"{name}.txt")
    rgb_t, rgb_j = ttum.read_list(lists["rgb"]), jtum.read_list(lists["rgb"])
    dep_t, dep_j = ttum.read_list(lists["depth"]), jtum.read_list(lists["depth"])
    gt_t, gt_j = ttum.read_groundtruth(lists["gt"]), jtum.read_groundtruth(lists["gt"])
    assert rgb_t == rgb_j and dep_t == dep_j and len(gt_t) == len(gt_j) == 20
    assert ttum.read_list(str(tmp_path / "none.txt")) == []
    ent_t = ttum.associate(rgb_t, dep_t, gt_t, "root")
    ent_j = jtum.associate(rgb_j, dep_j, gt_j, "root")
    assert 0 < len(ent_t) == len(ent_j) < 40          # the gate drops some
    for a, b in zip(ent_t, ent_j):
        assert (a.timestamp, a.rgb_path, a.depth_path) == (
            b.timestamp, b.rgb_path, b.depth_path)
        np.testing.assert_array_equal(a.gt_t, b.gt_t)
        np.testing.assert_array_equal(a.gt_q, b.gt_q)
    assert ttum.associate(rgb_t, [], gt_t, "root") == []

    # intrinsics: the stock calibrations, a file, a short file, no version
    for seq in ("x_freiburg1_y", "x_freiburg2_y", "x_freiburg3_y", "nothing"):
        a, b = ttum.load_intrinsics(str(tmp_path), seq), jtum.load_intrinsics(str(tmp_path), seq)
        assert (a is None and b is None) or vars(a) == vars(b)
    (tmp_path / "color_camera_freiburg2.txt").write_text(
        "# fx fy cx cy k1 k2 p1 p2 k3\n500 501 320 240 0.1 -0.2 0.001 0.002 0.3\n")
    (tmp_path / "color_camera_freiburg3.txt").write_text("500 501 320\n")
    for seq in ("a_freiburg2", "a_freiburg3"):
        a, b = ttum.load_intrinsics(str(tmp_path), seq), jtum.load_intrinsics(str(tmp_path), seq)
        assert (a is None and b is None) or vars(a) == vars(b)


def test_degradations_equal_bits():
    g, d, _ = tsynthetic.make_sequence(2, seed=1)
    for name in tdegrade.DEGRADATIONS:
        gt_, dt_ = tdegrade.DEGRADATIONS[name](g, d, np.random.default_rng(8))
        gj_, dj_ = jdegrade.DEGRADATIONS[name](g, d, np.random.default_rng(8))
        np.testing.assert_array_equal(gt_, gj_, err_msg=name)
        np.testing.assert_array_equal(dt_, dj_, err_msg=name)
    ga, da = tdegrade.degrade_all(g, d, np.random.default_rng(8))
    gb, db = jdegrade.degrade_all(g, d, np.random.default_rng(8))
    np.testing.assert_array_equal(ga, gb)
    np.testing.assert_array_equal(da, db)
    assert ga.dtype == np.uint8 and (da == 0).any()


def test_trajectory_functions_match(tmp_path):
    """write/read/associate/rpe against the JAX package's (scipy): files
    read back within 1e-9 either way, rotations equal up to q's sign."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(10)
    n = 12
    Ts = np.tile(np.eye(4), (n, 1, 1))
    Ts[:, :3, :3] = Rotation.random(n, random_state=3).as_matrix()
    Ts[:, :3, 3] = rng.normal(size=(n, 3))
    Ts[0, :3, :3] = np.diag([1.0, -1.0, -1.0])        # a half turn: w = 0
    ts = 1305031102.0 + np.arange(n) / 30.0
    for R in Ts[:, :3, :3]:
        q = matrix_to_quat_xyzw(R)
        qs = Rotation.from_matrix(R).as_quat()
        assert min(np.abs(q - qs).max(), np.abs(q + qs).max()) <= 1e-6
        np.testing.assert_allclose(quat_xyzw_to_matrix(q), R, atol=1e-9)
        np.testing.assert_allclose(quat_xyzw_to_matrix(3.0 * qs),
                                   Rotation.from_quat(qs).as_matrix(), atol=1e-9)
    pt, pj = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    ttraj.write_tum_trajectory(pt, ts, Ts)
    jtraj.write_tum_trajectory(pj, ts, Ts)
    for reader in (ttraj.read_tum_trajectory, jtraj.read_tum_trajectory):
        (ts_a, Ta), (ts_b, Tb) = reader(pt), reader(pj)
        np.testing.assert_allclose(ts_a, ts_b, atol=1e-9)
        # 6 decimals of a quaternion whose sign the writers may choose apart
        np.testing.assert_allclose(Ta, Tb, atol=5e-6)
    np.testing.assert_allclose(ttraj.read_tum_trajectory(pj)[1],
                               jtraj.read_tum_trajectory(pj)[1], atol=1e-9)
    np.testing.assert_allclose(ttraj.read_tum_trajectory(pt)[1], Ts, atol=5e-6)

    ts_b = np.sort(ts[::2] + rng.uniform(-0.03, 0.03, n // 2))[::-1].copy()
    assert (ttraj.associate_trajectories(ts, ts_b)
            == jtraj.associate_trajectories(ts, ts_b))
    assert ttraj.associate_trajectories(ts, np.array([])) == []
    noisy = Ts.copy()
    noisy[:, :3, 3] += rng.normal(scale=0.01, size=(n, 3))
    noisy[:, :3, :3] = noisy[:, :3, :3] @ Rotation.from_rotvec(
        rng.normal(scale=0.01, size=(n, 3))).as_matrix()
    for delta in (1, 3, 20):
        np.testing.assert_allclose(ttraj.rpe_rmse(noisy, Ts, delta),
                                   jtraj.rpe_rmse(noisy, Ts, delta), atol=1e-9)
    assert ttraj.rpe_rmse(noisy, Ts)[0] > 0
