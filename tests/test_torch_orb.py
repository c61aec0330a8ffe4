"""ORB of the port against ``orb_jax.orb_extract``: the numpy tables are
array-equal, and on a rendered 640x480 frame the valid keypoints sit at the
same pixels (>= 0.95 of the port's valid slots) with the same descriptor
bits (>= 0.99 among those keypoints).

The JAX side runs its CPU path (XLA dense passes with wrap-around shifts,
FAST compares in bf16) against the port's plain K1 version (edge padding,
f32 compares): they differ only under the border mask and at rounding
ties. The port resizes its pyramid in f32 and casts once, which is the
JAX package's ``resize_f32=1`` mode; against its default bf16 resize the
pyramid levels differ by bf16 rounding, which moves more corners. Measured
on frames 0-3 of the bench sequence: overlap 0.977-0.987 with bits
agreeing >= 0.9997 against ``resize_f32=1``, and overlap 0.942-0.970 with
bits agreeing >= 0.994 against the bf16 default.
"""

import numpy as np
import pytest
import torch

from visionx_slam_tpu.models import orb_jax as OJ

from visionx_slam_torch import convert
from visionx_slam_torch.models import orb_torch as OT

from torch_parity import sequence, t, to_np


def test_tables_equal_the_jax_package():
    np.testing.assert_array_equal(OT.FAST_CIRCLE, OJ.FAST_CIRCLE)
    np.testing.assert_array_equal(OT.brief_pattern(), OJ.brief_pattern())
    np.testing.assert_array_equal(OT._gaussian_kernel1d(), OJ._gaussian_kernel1d())
    for args in [(1000, 8, 1.2), (100, 2, 1.2), (500, 4, 1.5)]:
        assert OT._level_quotas(*args) == OJ._level_quotas(*args)
    for args in [(480, 640, 8, 1.2, 31), (120, 160, 2, 1.2, 31)]:
        p_t, n_t, m_t = OT._atlas_layout(*args)
        p_j, n_j, m_j = OJ._atlas_layout(*args)
        assert p_t == p_j and n_t == n_j
        np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(OT._brief_bank(), OJ._brief_bank())
    # convert.py hands out the same table functions
    assert convert._brief_bank is OT._brief_bank


def test_brief_pairs_reproduce_the_bank():
    """Gathering the (plus, minus) samples equals the bank contraction."""
    rng = np.random.default_rng(0)
    flat = rng.integers(0, 256, (40, OT.PATCH_S**2)).astype(np.float32)
    D = OT._brief_bank()
    plus, minus = OT._brief_pairs()
    by_bank = (flat @ D).reshape(40, OT.BRIEF_BINS, 256)
    by_pairs = flat[:, plus] - flat[:, minus]
    np.testing.assert_array_equal(by_bank, by_pairs)


@pytest.fixture(scope="module")
def frames():
    grays, _, _ = sequence(2, 5)
    return grays


@pytest.fixture(scope="module")
def frame(frames):
    return frames[0]


@pytest.fixture(scope="module")
def port_out(frames):
    px, resp, desc, valid = OT.orb_extract(t(frames))
    return to_np(px), to_np(desc), to_np(valid)


def _by_position(px, desc, valid):
    keys = np.round(px[valid] * 64).astype(np.int64)
    return {tuple(k): d for k, d in zip(keys, desc[valid])}


@pytest.mark.parametrize("fi", [0, 1])
@pytest.mark.parametrize("resize_f32, min_overlap", [(1, 0.95), (0, 0.93)])
def test_keypoints_and_descriptors_match_jax(frames, port_out, fi, resize_f32,
                                             min_overlap):
    px_j, _, desc_j, valid_j = (np.asarray(a) for a in OJ.orb_extract(
        frames[fi], use_pallas=0, resize_f32=resize_f32))
    px_t, desc_t, valid_t = (a[fi] for a in port_out)
    assert valid_t.sum() > 900 and valid_j.sum() > 900
    ref = _by_position(px_j, desc_j, valid_j)
    mine = _by_position(px_t, desc_t, valid_t)
    shared = [k for k in mine if k in ref]
    overlap = len(shared) / len(mine)
    assert overlap >= min_overlap, f"keypoint overlap {overlap:.4f}"
    bits = np.unpackbits(np.stack([mine[k] for k in shared]) ^
                         np.stack([ref[k] for k in shared]))
    agree = 1.0 - bits.mean()
    assert agree >= 0.99, f"descriptor bit agreement {agree:.4f}"


def test_batch_and_slot_layout(frame):
    g = t(np.stack([frame, frame[:, ::-1].copy()]))
    px, resp, desc, valid = OT.orb_extract(g, n_slots=1024)
    assert px.shape == (2, 1024, 2) and desc.dtype == torch.uint8
    one = OT.orb_extract(g[1:])
    np.testing.assert_array_equal(to_np(desc[1]), to_np(one[2][0]))
    # fewer slots than features: valid entries first (stable compaction)
    px_s, _, _, valid_s = OT.orb_extract(g[:1], n_slots=512)
    v = to_np(valid_s[0])
    assert v.all() or not v[np.argmin(v):].any()
