"""The plain reference's side of a TUM RGB-D directory: the writers of the
files a run reads, and the readers of the files it leaves. NumPy, zlib and
struct only; nothing of the program, of torch or of JAX.

- ``write_png``: 8-bit RGB and 16-bit gray PNGs as TUM distributes them,
  non-interlaced, filter None on every scanline (the benchmark's own
  encoder, so the decoder under test reads bytes the program did not make).
- ``write_sequence``: a TUM directory (``rgb/``, ``depth/``, ``rgb.txt``,
  ``depth.txt``, ``groundtruth.txt`` and ``color_camera_freiburgN.txt``).
- ``read_trajectory``: a TUM trajectory file (timestamps and camera
  positions and rotations, camera to world).
- ``read_map``: ``map_snapshot.npz`` into the arrays of
  ``judge.map_numbers``.
- ``obs_depth_errors``: every error that ``judge.map_numbers`` takes the
  median of for ``obs_depth_mm``, one an observation.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MAP_FIELDS = ("kf_q", "kf_t", "kf_id", "kf_px", "kf_fvalid", "kf_feat_lm",
              "kf_depth", "lm_pos", "lm_alive")
_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """[H,W,3] uint8 (RGB, colour type 2) or [H,W] uint16 (gray, colour
    type 0, big-endian samples) as the PNG file ``path`` (zlib level 1:
    the files are written in set-up)."""
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, colour, rows = 8, 2, img.reshape(img.shape[0], -1)
    elif img.dtype == np.uint16 and img.ndim == 2:
        depth, colour = 16, 0
        rows = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    else:
        raise ValueError(f"not a TUM image: {img.dtype} {img.shape}")
    height, width = img.shape[:2]
    lines = np.zeros((height, 1 + rows.shape[1]), np.uint8)   # filter None
    lines[:, 1:] = rows
    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                              colour, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(lines.tobytes(), 1))
                + _chunk(b"IEND", b""))


def _list(path: str, header: str, lines: list[str]) -> None:
    with open(path, "w") as f:
        f.write(header + "\n" + "".join(line + "\n" for line in lines))


def _quat_xyzw(R: np.ndarray) -> np.ndarray:
    """[n,3,3] rotations -> [n,4] unit quaternions (x, y, z, w), w >= 0:
    the top eigenvector of Bar-Itzhack's symmetric 4x4 form."""
    m = lambda i, j: R[:, i, j]
    K = np.stack([
        np.stack([m(0, 0) - m(1, 1) - m(2, 2), m(1, 0) + m(0, 1), m(2, 0) + m(0, 2), m(2, 1) - m(1, 2)], -1),
        np.stack([m(1, 0) + m(0, 1), m(1, 1) - m(0, 0) - m(2, 2), m(2, 1) + m(1, 2), m(0, 2) - m(2, 0)], -1),
        np.stack([m(2, 0) + m(0, 2), m(2, 1) + m(1, 2), m(2, 2) - m(0, 0) - m(1, 1), m(1, 0) - m(0, 1)], -1),
        np.stack([m(2, 1) - m(1, 2), m(0, 2) - m(2, 0), m(1, 0) - m(0, 1), m(0, 0) + m(1, 1) + m(2, 2)], -1),
    ], -2)
    q = np.linalg.eigh(K)[1][..., -1]
    return q * np.where(q[:, 3:] < 0, -1.0, 1.0)


def write_sequence(root: str, sequence: str, cam: dict, timestamps,
                   gray: np.ndarray, depth_units: np.ndarray, R_wc, t_wc,
                   threads: int = 8) -> str:
    """A TUM RGB-D directory ``root/sequence`` of frames ``gray`` [T,H,W]
    uint8 (written as 8-bit RGB, R = G = B) and ``depth_units`` [T,H,W]
    uint16 (units of 1/``cam["depth_scale"]`` m), taken at ``timestamps``
    [T] (s) from camera-to-world poses (R_wc [T,3,3], t_wc [T,3]) that
    ``groundtruth.txt`` holds. ``cam``: width, height, fx, fy, cx, cy;
    ``color_camera_freiburgN.txt`` (N from the sequence's name) gives them
    with zero distortion. Returns the sequence directory."""
    seq = os.path.join(root, sequence)
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(seq, sub), exist_ok=True)
    names = [f"{t:.6f}.png" for t in timestamps]

    def one(i):
        write_png(os.path.join(seq, "rgb", names[i]),
                  np.repeat(gray[i][..., None], 3, axis=-1))
        write_png(os.path.join(seq, "depth", names[i]), depth_units[i])

    with ThreadPoolExecutor(threads) as pool:     # zlib lets go of the GIL
        list(pool.map(one, range(len(names))))
    _list(os.path.join(seq, "rgb.txt"), "# color images\n# timestamp filename",
          [f"{t:.6f} rgb/{n}" for t, n in zip(timestamps, names)])
    _list(os.path.join(seq, "depth.txt"), "# depth maps\n# timestamp filename",
          [f"{t:.6f} depth/{n}" for t, n in zip(timestamps, names)])
    q = _quat_xyzw(np.asarray(R_wc, np.float64))
    _list(os.path.join(seq, "groundtruth.txt"),
          "# ground truth trajectory\n# timestamp tx ty tz qx qy qz qw",
          [f"{t:.6f} " + " ".join(f"{x:.6f}" for x in (*p, *r))
           for t, p, r in zip(timestamps, np.asarray(t_wc), q)])
    version = next(v for v in "123" if f"freiburg{v}" in sequence)
    _list(os.path.join(root, f"color_camera_freiburg{version}.txt"),
          "# fx fy cx cy k1 k2 p1 p2 k3",
          [f"{cam['fx']} {cam['fy']} {cam['cx']} {cam['cy']} 0 0 0 0 0"])
    return seq


def quat_to_R(q: np.ndarray) -> np.ndarray:
    """[...,4] quaternions (w, x, y, z) -> [...,3,3]."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def read_trajectory(path: str) -> tuple[np.ndarray, np.ndarray]:
    """A TUM trajectory file (``timestamp tx ty tz qx qy qz qw`` lines,
    camera to world, '#' comments) -> (timestamps [n], T_cw [n,4,4])."""
    with open(path) as f:
        rows = [line.split() for line in f
                if line.strip() and not line.startswith("#")]
    v = np.array([[float(x) for x in r[:8]] for r in rows]).reshape(-1, 8)
    R_wc = quat_to_R(v[:, [7, 4, 5, 6]])
    T = np.tile(np.eye(4), (len(v), 1, 1))
    T[:, :3, :3] = np.transpose(R_wc, (0, 2, 1))
    T[:, :3, 3] = -np.einsum("nji,nj->ni", R_wc, v[:, 1:4])
    return v[:, 0], T


def frames_of(timestamps: np.ndarray, written: np.ndarray) -> np.ndarray:
    """The index of the written frame each timestamp names (-1 where none
    lies within 1 ms)."""
    i = np.clip(np.searchsorted(written, timestamps), 1, len(written) - 1)
    i = np.where(np.abs(written[i - 1] - timestamps)
                 <= np.abs(written[i] - timestamps), i - 1, i)
    return np.where(np.abs(written[i] - timestamps) <= 1e-3, i, -1)


def read_map(path: str) -> dict:
    """``map_snapshot.npz`` -> the map's arrays under their names."""
    with np.load(path) as z:
        return {f: z[f] for f in MAP_FIELDS}


def obs_depth_errors(m: dict, size: tuple[int, int], true_depth) -> np.ndarray:
    """|depth of the landmark in the observing keyframe - the true depth
    along the observed pixel's ray| (m) for every observation of a live
    landmark by a used keyframe at a pixel inside the ``size`` (width,
    height) image, as ``judge.map_numbers`` selects them.
    ``true_depth(kf_ids, u, v)`` gives the truth at the keyframes' frame
    ids for the rounded pixels."""
    used = m["kf_id"] >= 0
    kid = m["kf_id"][used].astype(np.int64)
    Rk = quat_to_R(m["kf_q"][used].astype(np.float64))
    tk = m["kf_t"][used].astype(np.float64)
    px = np.transpose(m["kf_px"][used], (0, 2, 1)).astype(np.float64)
    fvalid = m["kf_fvalid"][used]
    K, N = fvalid.shape
    u, v = np.round(px[..., 0]), np.round(px[..., 1])
    inside = (u >= 0) & (u < size[0]) & (v >= 0) & (v < size[1])
    kk = np.broadcast_to(np.arange(K)[:, None], (K, N))
    lm = m["kf_feat_lm"][used].astype(np.int64)
    obs = fvalid & inside & (lm >= 0)
    obs[obs] = m["lm_alive"][lm[obs]]
    X = m["lm_pos"][:, lm[obs]].T.astype(np.float64)
    z = (np.einsum("mij,mj->mi", Rk[kk[obs]], X) + tk[kk[obs]])[:, 2]
    return np.abs(z - true_depth(kid[kk[obs]], u[obs], v[obs]))
