"""``match_frames`` of the port is integer-exact against the JAX package
(idx, dist, valid), batched over pairs, on random and on real ORB
descriptors; so is ``match_frames_batched``, whose distance filter keeps
one threshold per pair, as JAX's ``vmap`` of ``match_frames`` does."""

import numpy as np
import pytest
import torch

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


def _noisy_copies(rng, P, N, flip_rates):
    """(desc_a, desc_b) [P, N, 32]: pair p's train set is a permutation of
    its queries with each bit flipped at ``flip_rates[p]``."""
    da = rng.integers(0, 256, (P, N, 32), dtype=np.uint8)
    db = np.empty_like(da)
    for p in range(P):
        flips = rng.random((N, 256)) < flip_rates[p]
        db[p] = da[p, rng.permutation(N)] ^ np.packbits(flips, axis=-1,
                                                         bitorder="little")
    return da, db


def test_batched_matching_exact():
    """``match_frames_batched`` as the JAX package's own test drives it (4
    pairs of 64 descriptors): integer-exact against JAX's, and each row
    equals the port's unbatched ``match_frames`` on its pair."""
    rng = np.random.default_rng(42)
    da, db = _noisy_copies(rng, 4, 64, [0.05, 0.15, 0.25, 0.5])
    va = rng.random((4, 64)) > 0.1
    vb = rng.random((4, 64)) > 0.1
    res = TM.match_frames_batched(t(da), t(va), t(db), t(vb))
    ref = JM.match_frames_batched(da, va, db, vb, TM.NN_RATIO)
    assert res.idx.shape == res.dist.shape == res.valid.shape == (4, 64)
    for f in ("idx", "dist", "valid"):
        np.testing.assert_array_equal(to_np(getattr(res, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for p in range(4):
        one = TM.match_frames(t(da[p]), t(va[p]), t(db[p]), t(vb[p]))
        for f in ("idx", "dist", "valid"):
            assert torch.equal(getattr(res, f)[p], getattr(one, f)), (p, f)
    assert int(res.valid[3].sum()) < int(res.valid[0].sum())


def test_batched_distance_filter_is_per_pair():
    """Pair 0 holds near-copies (best distance a few bits: its threshold is
    the 30 floor); the other pairs' matches lie at 40-90 bits. A threshold
    shared across the batch would drop them all; each pair keeps its own,
    as under JAX's vmap."""
    rng = np.random.default_rng(7)
    da, db = _noisy_copies(rng, 3, 64, [0.01, 0.25, 0.3])
    va = np.ones((3, 64), bool)
    res = TM.match_frames_batched(t(da), t(va), t(db), t(va), 0.9)
    ref = JM.match_frames_batched(da, va, db, va, 0.9)
    for f in ("idx", "dist", "valid"):
        np.testing.assert_array_equal(to_np(getattr(res, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    # pair 0's threshold: max(2 x its best distance, 30) = 30
    assert float(res.dist[0][res.valid[0]].min()) < 15
    for p in (1, 2):
        kept = res.dist[p][res.valid[p]]
        assert len(kept) > 20 and float(kept.min()) > 30, (p, kept)


def test_batched_matching_wants_a_batch():
    a = torch.zeros((64, 32), dtype=torch.uint8)
    v = torch.ones(64, dtype=torch.bool)
    with pytest.raises(ValueError, match=r"\[B, N, 32\]"):
        TM.match_frames_batched(a, v, a, v)
    with pytest.raises(ValueError, match="2 query frames against 3"):
        TM.match_frames_batched(a.expand(2, 64, 32), v.expand(2, 64),
                                a.expand(3, 64, 32), v.expand(3, 64))
