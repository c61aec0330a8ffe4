"""ORB of the port against ``orb_jax.orb_extract``: the numpy tables are
array-equal, the pyramid atlas equals the JAX package's default bf16 build
bit for bit at all 8 levels, and on rendered 640x480 frames the valid
keypoints sit at the same pixels with the same descriptor bits.

The JAX side runs its CPU path (XLA dense passes with wrap-around shifts,
FAST compares in bf16) against the port's plain K1 version (edge padding,
f32 compares): they differ only under the border mask and at rounding
ties. Measured on frames 0-3 of the bench sequence (port and JAX in the
same resize mode): keypoint overlap 0.979-0.990 with every descriptor bit
equal in the default bf16 mode, 0.977-0.987 with bits agreeing >= 0.9997
in ``resize_f32=1`` (its float32 sums round differently in ~0.05% of the
pixels).

At the shared keypoints the Harris responses equal JAX's to 2% (measured
on frame 0 in the default mode: 1 of 972 over 1%, 1.08%).

``use_kernel``: 1 raises on the CPU, 0 equals the default there.
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
    out = {}
    for rf in (0, 1):
        px, resp, desc, valid = OT.orb_extract(t(frames), resize_f32=rf)
        out[rf] = to_np(px), to_np(resp), to_np(desc), to_np(valid)
    return out


@pytest.fixture(scope="module")
def jax_out(frames):
    """``orb_jax.orb_extract`` of frame ``fi`` in mode ``resize_f32``, each
    run once for the tests of this module that compare against it."""
    memo = {}

    def get(fi, resize_f32):
        if (fi, resize_f32) not in memo:
            memo[fi, resize_f32] = tuple(np.asarray(a) for a in OJ.orb_extract(
                frames[fi], use_pallas=0, resize_f32=resize_f32))
        return memo[fi, resize_f32]
    return get


def _by_position(px, vals, valid):
    keys = np.round(px[valid] * 64).astype(np.int64)
    return {tuple(k): d for k, d in zip(keys, vals[valid])}


@pytest.mark.parametrize("fi", [0, 1])
@pytest.mark.parametrize("resize_f32, min_overlap", [(1, 0.95), (0, 0.975)])
def test_keypoints_and_descriptors_match_jax(jax_out, port_out, fi, resize_f32,
                                             min_overlap):
    px_j, _, desc_j, valid_j = jax_out(fi, resize_f32)
    px_t, _, desc_t, valid_t = (a[fi] for a in port_out[resize_f32])
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


@pytest.mark.parametrize("fi", [0, 1])
@pytest.mark.parametrize("resize_f32", [1, 0])
def test_responses_match_jax(jax_out, port_out, fi, resize_f32):
    """The Harris responses of the full extraction at the keypoints both
    packages find."""
    px_j, resp_j, _, valid_j = jax_out(fi, resize_f32)
    px_t, resp_t, _, valid_t = (a[fi] for a in port_out[resize_f32])
    ref = _by_position(px_j, resp_j, valid_j)
    mine = _by_position(px_t, resp_t, valid_t)
    shared = [k for k in mine if k in ref]
    assert len(shared) > 900
    np.testing.assert_allclose([mine[k] for k in shared],
                               [ref[k] for k in shared], rtol=2e-2)


def _levels(H=480, W=640):
    place, _, _ = OT._atlas_layout(H, W, 8, 1.2, 31)
    return place


def test_resize_weights_equal_jax_in_bf16():
    """Every level's weight matrices, rounded to bf16 as the default pyramid
    uses them, equal JAX's (resizing an identity gives JAX's matrix); in
    float32 they agree to a few ulps (summation order)."""
    import jax
    import jax.numpy as jnp

    for (_, _, h, w) in _levels()[1:]:
        for n, m in ((480, h), (640, w)):
            wj = np.asarray(jax.image.resize(jnp.eye(n, dtype=jnp.float32), (m, n),
                                             method="linear"))
            wt = OT.resize_weights(n, m)
            np.testing.assert_allclose(wt, wj, rtol=0, atol=5e-7)
            np.testing.assert_array_equal(
                to_np(torch.from_numpy(wt).to(torch.bfloat16).float()),
                np.asarray(jnp.asarray(wj).astype(jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("seed", [5, 7])
def test_default_atlas_equals_jax_bit_for_bit(seed):
    """The port's default atlas against ``jax.image.resize`` of the bf16
    frame (``orb_jax``'s default, ``resize_f32=0``) at all 8 levels."""
    import jax
    import jax.numpy as jnp

    grays, _, _ = sequence(2, seed)
    atlas, _ = OT.build_atlas(t(grays))
    for f in range(2):
        img = jnp.asarray(grays[f]).astype(jnp.bfloat16)
        for lvl, (oy, ox, h, w) in enumerate(_levels()):
            ref = img if lvl == 0 else jax.image.resize(img, (h, w), method="linear")
            np.testing.assert_array_equal(
                to_np(atlas[f, oy:oy + h, ox:ox + w].float()),
                np.asarray(ref.astype(jnp.float32)), err_msg=f"frame {f} level {lvl}")


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


def test_use_kernel(frame):
    g = t(frame[None])
    with pytest.raises(ValueError, match="CUDA"):
        OT.orb_extract(g, use_kernel=1)
    for a, b in zip(OT.orb_extract(g, use_kernel=0), OT.orb_extract(g)):
        assert torch.equal(a, b)
