"""``match_frames`` of the port is integer-exact against the JAX package
(idx, dist, valid), batched over pairs, on random and on real ORB
descriptors."""

import numpy as np
import pytest

from visionx_slam_tpu.models import matching as JM
from visionx_slam_tpu.models import orb_jax as OJ

from visionx_slam_torch.models import matching as TM

from torch_parity import sequence, t, to_np


def _assert_exact(res_t, desc_a, valid_a, desc_b, valid_b):
    for p in range(desc_a.shape[0]):
        r = JM.match_frames(desc_a[p], valid_a[p], desc_b[p], valid_b[p])
        np.testing.assert_array_equal(to_np(res_t.idx[p]), np.asarray(r.idx))
        np.testing.assert_array_equal(to_np(res_t.dist[p]), np.asarray(r.dist))
        np.testing.assert_array_equal(to_np(res_t.valid[p]), np.asarray(r.valid))


def test_random_descriptors_exact():
    rng = np.random.default_rng(5)
    P, N = 3, 300
    da = rng.integers(0, 256, (P, N, 32), dtype=np.uint8)
    # the train set: noisy copies of a permutation of the queries, so the
    # ratio test and the distance filter both have work to do
    perm = rng.permutation(N)
    flips = (rng.random((P, N, 256)) < rng.uniform(0.0, 0.3, (P, N, 1)))
    db = da[:, perm] ^ np.packbits(flips, axis=-1, bitorder="little")
    va = rng.random((P, N)) > 0.1
    vb = rng.random((P, N)) > 0.1
    vb[2] = False                      # a pair with no valid train descriptor
    res = TM.match_frames(t(da), t(va), t(db), t(vb))
    assert 10 < int(res.valid[:2].sum()) < 2 * N
    _assert_exact(res, da, va, db, vb)


def test_hamming_matrix_matches_popcount():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (20, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (30, 32), dtype=np.uint8)
    ref = np.unpackbits(a[:, None] ^ b[None], axis=-1).sum(-1)
    np.testing.assert_array_equal(to_np(TM.hamming_matrix(t(a), t(b))), ref)
    np.testing.assert_array_equal(
        np.asarray(JM.hamming_matrix(a, b)).astype(np.float32), ref)


@pytest.mark.parametrize("pair", [(0, 1), (0, 3)])
def test_real_orb_descriptors_exact(pair):
    grays, _, _ = sequence(4, 5)
    outs = [OJ.orb_extract(grays[i], use_pallas=0) for i in pair]
    desc_a, valid_a = (np.asarray(x)[None] for x in (outs[0][2], outs[0][3]))
    desc_b, valid_b = (np.asarray(x)[None] for x in (outs[1][2], outs[1][3]))
    res = TM.match_frames(t(desc_a), t(valid_a), t(desc_b), t(valid_b))
    assert int(res.valid.sum()) > 200
    _assert_exact(res, desc_a, valid_a, desc_b, valid_b)
