"""Rotation matrix <-> quaternion on the host (numpy, float64), in the TUM
file order ``xyzw``. The JAX package calls scipy's ``Rotation`` for this in
its trajectory files, its dataset writer, its ground-truth matrices and its
host tracker; the port has one pair of functions and no scipy dependency.

A rotation has two quaternions, q and -q. ``matrix_to_quat_xyzw`` picks the
one scipy's ``Rotation.from_matrix(R).as_quat()`` picks (the largest of the
trace and the diagonal decides the branch, no sign canonicalisation), but
callers that compare must compare rotations, i.e. up to sign.
"""

from __future__ import annotations

import numpy as np


def matrix_to_quat_xyzw(R: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> unit quaternion [x, y, z, w] (float64)."""
    m = np.asarray(R, np.float64)
    trace = m[0, 0] + m[1, 1] + m[2, 2]
    decision = np.array([m[0, 0], m[1, 1], m[2, 2], trace])
    choice = int(np.argmax(decision))
    q = np.empty(4)
    if choice != 3:
        i = choice
        j = (i + 1) % 3
        k = (j + 1) % 3
        q[i] = 1.0 - trace + 2.0 * m[i, i]
        q[j] = m[j, i] + m[i, j]
        q[k] = m[k, i] + m[i, k]
        q[3] = m[k, j] - m[j, k]
    else:
        q[0] = m[2, 1] - m[1, 2]
        q[1] = m[0, 2] - m[2, 0]
        q[2] = m[1, 0] - m[0, 1]
        q[3] = 1.0 + trace
    return q / np.linalg.norm(q)


def quat_xyzw_to_matrix(q: np.ndarray) -> np.ndarray:
    """Quaternion [x, y, z, w] (any non-zero norm) -> 3x3 rotation matrix."""
    x, y, z, w = np.asarray(q, np.float64) / max(np.linalg.norm(q), 1e-300)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
