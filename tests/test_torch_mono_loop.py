"""The monocular loop closure of the port's offline pipeline against the JAX
package, stage by stage on identical numpy inputs.

- ``_scale_loop_correction`` at the shapes of
  tests/test_offline_mono.py::test_scale_loop_correction_gates (32 frames of
  256 random descriptors): unique frames give factor exactly 1 and nothing
  verified; frames 16-31 revisiting frames 0-15 exactly, with depths scaled
  by e^0.3, give the JAX package's factors within 1e-6 relative and its
  verified frames. Two folded lanes (the revisit lane, and a lane whose
  first half copies lane 0's frames, whose rotation gate rejects half of
  its revisits and whose frame 20 has too few depths): the same agreement,
  and the port's lane 0 equals its single run bit for bit.
- ``_close_loops`` on the JAX package's ``build_keyframe_map`` of 16
  keyframes (frames 0, 3, ..., 45) of 48 frames that go twice round a
  24-frame loop (ground-truth poses, rendered depth), carried over with
  ``convert.py``. The second round images the first exactly, so every
  revisiting pair's similarity is 1 up to float32 rounding, and the order of
  the greedy selection would be the rounding's (the JAX package's GEMM
  rounds a folded map's similarities otherwise than a single one's); so
  each keyframe of the second round drops a different share of its
  features (1 in 40 more per keyframe), which orders the pairs by more than
  rounding. Equal to the JAX package's: the merged tables (``kf_feat_lm``, ``lm_alive``,
  ``lm_obs``) and the counts of verified pairs and merged links are equal,
  with a budget of 6 pairs (fewer than the revisits, so the greedy
  selection decides); the same on a folded map of two such lanes (the
  second of frames 1, 4, ..., 46) with a budget per lane; and on a map where
  two features of a revisiting keyframe carry one descriptor, so two early
  landmarks claim one late landmark and the last in flat order must win.
- The place similarities: exact cosines (float64 of the integer
  descriptors, against numpy), so copied frames tie exactly, a folded
  block equals its single run, and the JAX package's float32 GEMM is met
  within its rounding (1e-5 for 256-term float32 sums).
- ``build_keyframe_map`` on lane 0's keyframes with pose noise and 40% of
  the depths dropped (features without depth adopt): integer tables and
  links equal to the JAX package's, landmark positions within 1e-5 m;
  ``lm_capacity`` of 3000 rows: the same dropped count.
- ``_chunked`` over folded lanes batches each lane's rows as a single run
  of the lane would (what makes a folded mono lane equal its single run on
  the card).
- ``torch_parity.OrbMemo`` (the pipeline tests' per-frame ORB cache)
  returns what ``orb_extract`` returns for a chunk of frames in any order.
- The keyword names of ``build_offline_pipeline``, ``build_keyframe_map``
  and ``_link_consecutive_keyframes`` are the JAX package's, less the JAX
  pipeline's ``cam_static_placeholder`` and the map builder's
  ``takeover`` and ``retriangulate`` (options nothing sets: the JAX
  pipeline passes False; ROADMAP's "Not to port").
"""

import functools
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visionx_slam_tpu.models import orb_jax as OJ
from visionx_slam_tpu.ops import se3 as jse3
from visionx_slam_tpu.tracking import offline_pipeline as JOP
from visionx_slam_tpu.tracking import stages as JS
from visionx_slam_tpu.tracking.mapstate import MapState as JMapState
from visionx_slam_tpu.utils.config import TrackingOptions as JOpts

from visionx_slam_torch import convert
from visionx_slam_torch.data import synthetic
from visionx_slam_torch.models.orb_torch import orb_extract
from visionx_slam_torch.tracking import offline_pipeline as TOP
from visionx_slam_torch.utils.config import TrackingOptions

from torch_parity import OrbMemo, cameras, sequence, t, to_np

# ---------------------------------------------------------------- scale


@functools.lru_cache(maxsize=None)
def _jax_scale(B):
    jc, _ = cameras()
    return jax.jit(lambda d, v, df, q: JOP._scale_loop_correction(
        jc, JOpts(), d, v, jnp.zeros(v.shape + (2,)), df, q, B, 12, 40,
        jax.random.PRNGKey(0)))


def _scale_inputs():
    rng = np.random.default_rng(0)
    T, N = 32, 256
    desc_u = rng.integers(0, 256, (T, N, 32), dtype=np.uint8)
    dfeat = rng.uniform(1.0, 3.0, (T, N)).astype(np.float32)
    revisit = np.concatenate([desc_u[:16], desc_u[:16]])
    dfeat_r = np.concatenate([dfeat[:16], dfeat[:16] * np.float32(np.exp(0.3))])
    return desc_u, dfeat, revisit, dfeat_r


def _z_quats(deg):
    h = np.deg2rad(np.asarray(deg, np.float64)) / 2
    return np.stack([np.cos(h), 0 * h, 0 * h, np.sin(h)], -1).astype(np.float32)


def _check_scale(desc, dfeat, q, B):
    valid = np.ones(desc.shape[:2], bool)
    f_j, v_j = _jax_scale(B)(desc, valid, dfeat, q)
    f_t, v_t = TOP._scale_loop_correction(t(desc), t(valid), t(dfeat), t(q), B, 12)
    np.testing.assert_allclose(to_np(f_t), np.asarray(f_j), rtol=1e-6)
    np.testing.assert_array_equal(to_np(v_t).reshape(B, -1).any(1), np.asarray(v_j))
    return to_np(f_t), to_np(v_t)


def test_scale_loop_correction_single_lane():
    desc_u, dfeat, revisit, dfeat_r = _scale_inputs()
    q = _z_quats(np.zeros(32))
    f, v = _check_scale(desc_u, dfeat, q, 1)
    assert not v.any()
    np.testing.assert_array_equal(f, 1.0)
    f, v = _check_scale(revisit, dfeat_r, q, 1)
    assert v[16:].sum() >= 8 and not v[:16].any()
    corrected = f[f < 0.999]
    assert len(corrected) >= 8
    np.testing.assert_allclose(corrected, np.exp(-0.3), rtol=0.1)


def test_scale_loop_correction_two_lanes():
    desc_u, dfeat, revisit, dfeat_r = _scale_inputs()
    rng = np.random.default_rng(1)
    other = rng.integers(0, 256, (16, 256, 32), dtype=np.uint8)
    # lane 1: its first half copies lane 0's first frames (cross-lane
    # copies must not be partners), its second half revisits its first
    lane1 = np.concatenate([revisit[:16], revisit[:16]])
    lane1[8:16] = other[8:16]
    lane1[24:32] = other[8:16]
    d1 = np.concatenate([dfeat[:16], dfeat[:16] * np.float32(np.exp(-0.2))])
    d1[20, 10:] = 0.0                  # 10 depths: below the count gate
    q0 = _z_quats(np.zeros(32))
    q1 = _z_quats(np.where(np.arange(32) >= 24, 60.0, 0.0))   # rotation gate
    f, v = _check_scale(np.concatenate([revisit, lane1]),
                        np.concatenate([dfeat_r, d1]), np.concatenate([q0, q1]), 2)
    assert v[32 + 16:32 + 24].sum() >= 4 and not v[32 + 24:].any() and not v[32 + 20]
    assert not v[32:32 + 16].any()
    f1, v1 = TOP._scale_loop_correction(t(revisit), torch.ones(32, 256, dtype=torch.bool),
                                        t(dfeat_r), t(q0), 1, 12)
    assert torch.equal(t(f[:32]), f1) and torch.equal(t(v[:32]), v1)


# ---------------------------------------------------------------- merge

LOOP, T_SEQ, KF = 24, 48, 16
N = 1024


@functools.lru_cache(maxsize=None)
def _kf_inputs(start):
    """Keyframe arrays of frames start, start + 3, ... of the two-loop
    sequence: ORB of the JAX package, ground-truth poses, rendered depth at
    the features."""
    frames = list(range(start, T_SEQ, 3))
    grays, depths, _ = sequence(T_SEQ, 13, LOOP)
    orb = jax.jit(lambda g: OJ.orb_extract(g, use_pallas=0))
    cols = {k: [] for k in ("q", "t", "px", "desc", "valid", "depth")}
    for f in frames:
        px, _, desc, valid = orb(grays[f])
        # second round: drop (f - LOOP + 1) / 40 of the features (docstring)
        keep = np.random.default_rng(f).random(N) >= max(f - LOOP + 1, 0) / 40
        valid = np.asarray(valid) & keep
        R_wc, t_wc = synthetic.trajectory_pose(f, T_SEQ, LOOP)
        cols["q"].append(np.asarray(jse3.matrix_to_quat(np.asarray(R_wc.T, np.float32))))
        cols["t"].append((-R_wc.T @ t_wc).astype(np.float32))
        cols["px"].append(np.asarray(px))
        cols["desc"].append(np.asarray(desc))
        cols["valid"].append(np.asarray(valid))
        cols["depth"].append(np.asarray(JS.sample_depth_image(depths[f], px, valid)))
    arr = {k: np.stack(v) for k, v in cols.items()}
    arr["id"] = np.asarray(frames, np.int32)
    return arr


def _jax_map(a):
    jc, _ = cameras()
    ms, _ = jax.jit(lambda *x: JOP.build_keyframe_map(
        jc, JOpts(), *x, KF * N, link_strides=(1, 2)))(
        a["q"], a["t"], a["id"], a["px"], a["desc"], a["valid"], a["depth"])
    return {f: np.asarray(getattr(ms, f)) for f in ms._fields}


@pytest.fixture(scope="module")
def lane_maps():
    return [_jax_map(_kf_inputs(s)) for s in (0, 1)]


@functools.lru_cache(maxsize=None)
def _jax_close_fn(n_pairs, spl):
    jc, _ = cameras()
    return jax.jit(lambda m: JOP._close_loops(m, jc, JOpts(), n_pairs, 12, 40,
                                              jax.random.PRNGKey(61),
                                              slots_per_lane=spl))


def _jax_close(ms, n_pairs, spl):
    out, n_ver, n_merged = _jax_close_fn(n_pairs, spl)(JMapState(**ms))
    return out, int(n_ver), int(n_merged)


def _check_close(ms, n_pairs, spl=None):
    out_j, ver_j, mer_j = _jax_close(ms, n_pairs, spl)
    out_t, ver_t, mer_t = TOP._close_loops(convert.mapstate_from_numpy(ms), n_pairs,
                                           12, 40, slots_per_lane=spl)
    for f in ("kf_feat_lm", "lm_alive", "lm_obs", "lm_pos", "kf_q"):
        np.testing.assert_array_equal(to_np(getattr(out_t, f)),
                                      np.asarray(getattr(out_j, f)), err_msg=f)
    assert (int(ver_t), int(mer_t)) == (ver_j, mer_j)
    # every live link points at a live landmark; counts are the links
    flm = to_np(out_t.kf_feat_lm)
    linked = flm[(flm >= 0) & to_np(out_t.kf_fvalid)]
    assert to_np(out_t.lm_alive)[linked].all()
    np.testing.assert_array_equal(
        to_np(out_t.lm_obs), np.bincount(linked, minlength=out_t.lm_obs.shape[0]))
    return out_t, ver_j, mer_j


def test_close_loops_matches_jax(lane_maps):
    _, n_ver, n_merged = _check_close(lane_maps[0], 6)
    assert n_ver >= 4 and n_merged > 500, (n_ver, n_merged)


def _merge_lanes(lanes):
    """Lane maps merged as the folded pipeline lays them out: slots
    lane-major, frame ids offset by the lane length, landmark tables
    concatenated with the links offset."""
    Lp = lanes[0]["lm_pos"].shape[1]
    out = {}
    for f in lanes[0]:
        vals = [m[f] for m in lanes]
        if f == "kf_feat_lm":
            vals = [np.where(v >= 0, v + b * Lp, v) for b, v in enumerate(vals)]
        if f == "kf_id":
            vals = [np.where(v >= 0, v + b * T_SEQ, v) for b, v in enumerate(vals)]
        if f == "lm_pos":
            out[f] = np.concatenate(vals, axis=1)
        elif np.ndim(vals[0]) == 0:
            out[f] = np.asarray(sum(vals), vals[0].dtype)
        else:
            out[f] = np.concatenate(vals)
    return out


def test_close_loops_folded_lanes_match_jax(lane_maps):
    out, n_ver, _ = _check_close(_merge_lanes(lane_maps), 12, spl=KF)
    one, n_ver0, _ = TOP._close_loops(convert.mapstate_from_numpy(lane_maps[0]), 6, 12, 40)
    # lane 0's block of the folded map is lane 0's own closure
    assert torch.equal(out.kf_feat_lm[:KF], one.kf_feat_lm)
    Lp = one.lm_physical
    assert torch.equal(out.lm_alive[:Lp], one.lm_alive)
    assert torch.equal(out.lm_obs[:Lp], one.lm_obs)
    assert n_ver > int(n_ver0)


def test_close_loops_exact_revisits_fold_equals_single(lane_maps):
    """Where the second round's keyframes copy the first round's, the
    similarities of the revisiting pairs differ only by rounding: the
    port's fixed-order sums round a folded map as a single one, so the
    greedy order, and the merge, of a folded lane are its single run's."""
    ms = {k: v.copy() for k, v in lane_maps[0].items()}
    late = ms["kf_id"] >= LOOP
    src = np.flatnonzero(late) - LOOP // 3
    for f in ("kf_desc", "kf_fvalid"):
        ms[f][late] = ms[f][src]
    one, ver1, mer1 = TOP._close_loops(convert.mapstate_from_numpy(ms), 6, 12, 40)
    two, ver2, mer2 = TOP._close_loops(convert.mapstate_from_numpy(_merge_lanes([ms, ms])),
                                       12, 12, 40, slots_per_lane=KF)
    Lp = one.lm_physical
    assert torch.equal(two.kf_feat_lm[:KF], one.kf_feat_lm)
    assert torch.equal(two.kf_feat_lm[KF:] - Lp * (two.kf_feat_lm[KF:] >= 0), one.kf_feat_lm)
    assert torch.equal(two.lm_obs[:Lp], one.lm_obs) and torch.equal(two.lm_obs[Lp:], one.lm_obs)
    assert (int(ver2), int(mer2)) == (2 * int(ver1), 2 * int(mer1)) and int(ver1) == 6


def test_close_loops_duplicate_claims_match_jax(lane_maps):
    """Two features of a revisited keyframe get one descriptor, so both
    match the same late feature: its landmark is claimed twice and the last
    claim in flat order wins, as in the JAX package."""
    ms = {k: v.copy() for k, v in lane_maps[0].items()}
    flm, desc = ms["kf_feat_lm"], ms["kf_desc"]
    q = 0                               # frame 0, revisited by frame 24
    live = np.flatnonzero((flm[q] >= 0) & ms["kf_fvalid"][q])
    dup = 0
    for a, b in zip(live[:200:2], live[1:200:2]):
        desc[q, b] = desc[q, a]
        dup += 1
    out, _, n_merged = _check_close(ms, 6)
    assert dup > 50 and n_merged > 0


# ---------------------------------------------------------------- similarity


def _jax_sim(desc, valid):
    """The JAX package's place similarity (``_close_loops`` step 1)."""
    bits = JOP.matching.unpack_bits(desc).astype(jnp.float32)
    G = jnp.einsum("knb,kn->kb", bits, valid.astype(jnp.float32))
    G = G / jnp.maximum(jnp.sum(valid, axis=1).astype(jnp.float32)[:, None], 1.0) - 0.5
    Gn = G / jnp.maximum(jnp.linalg.norm(G, axis=1, keepdims=True), 1e-9)
    return Gn @ Gn.T


def test_place_similarity_is_exact():
    """Random descriptors with repeats, empty and half-valid frames: the
    port's cosines are numpy's float64 ones rounded once to float32, so
    copies tie exactly and two blocks equal two single runs; the JAX
    package's float32 GEMM is within float32 rounding of them."""
    rng = np.random.default_rng(5)
    M, Nf = 24, 512
    desc = rng.integers(0, 256, (M, Nf, 32), dtype=np.uint8)
    desc[12:20] = desc[0:8]                          # copies
    valid = rng.random((M, Nf)) < 0.9
    valid[7] = False                                 # no feature: the 0.5 centre
    valid[5, Nf // 2:] = False
    valid[12:20] = valid[0:8]
    H = TOP._place_descriptors(t(desc), t(valid))
    sim = TOP._block_similarity(H, 1)[0]
    bits = np.unpackbits(desc, axis=-1, bitorder="little").astype(np.float64)
    n = np.maximum(valid.sum(1), 1)[:, None]
    G = (bits * valid[..., None]).sum(1) / n - 0.5
    Gn = G / np.maximum(np.linalg.norm(G, axis=1, keepdims=True), 1e-300)
    np.testing.assert_allclose(to_np(sim), (Gn @ Gn.T).astype(np.float32),
                               rtol=0, atol=2e-7)
    assert torch.equal(sim[:, 0:8], sim[:, 12:20]) and torch.equal(sim[0:8], sim[12:20])
    two = TOP._block_similarity(H, 2)
    assert torch.equal(two[0], TOP._block_similarity(H[:12], 1)[0])
    assert torch.equal(two[1], TOP._block_similarity(H[12:], 1)[0])
    # float32 sums of 256 terms in the JAX package: measured 1.6e-6 here
    np.testing.assert_allclose(to_np(sim), np.asarray(_jax_sim(desc, valid)),
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------- map


def _noisy_inputs():
    """Lane 0's keyframes with pose noise (2e-3 rad, 5 mm) and 40% of the
    depths dropped: features without depth adopt, and two-view DLT places
    landmarks elsewhere than the depths do."""
    a = dict(_kf_inputs(0))
    rng = np.random.default_rng(3)
    w = rng.normal(0, 2e-3, (KF, 3)).astype(np.float32)
    a["q"] = np.asarray(jse3.quat_mul(jse3.so3_exp(w), a["q"]))
    a["t"] = (a["t"] + rng.normal(0, 5e-3, a["t"].shape)).astype(np.float32)
    a["depth"] = np.where(rng.random(a["depth"].shape) < 0.4, 0.0,
                          a["depth"]).astype(np.float32)
    return a


def _both_maps(a, L, **kw):
    jc, tc = cameras()
    args = (a["q"], a["t"], a["id"], a["px"], a["desc"], a["valid"], a["depth"])
    ms_j, links_j = jax.jit(lambda *x: JOP.build_keyframe_map(
        jc, JOpts(), *x, L, link_strides=(1, 2), **kw))(*args)
    ms_t, links_t = TOP.build_keyframe_map(tc, TrackingOptions(), *(t(x) for x in args),
                                           L, link_strides=(1, 2), **kw)
    for f in ("kf_feat_lm", "lm_alive", "lm_obs", "next_lm", "lm_dropped"):
        np.testing.assert_array_equal(to_np(getattr(ms_t, f)),
                                      np.asarray(getattr(ms_j, f)), err_msg=f)
    for f in ("created", "adopter", "creator", "order", "sidx"):
        np.testing.assert_array_equal(to_np(getattr(links_t, f)),
                                      np.asarray(getattr(links_j, f)), err_msg=f)
    return ms_j, ms_t, links_t


def test_build_keyframe_map_noisy_matches_jax():
    a = _noisy_inputs()
    ms_j, ms_t, links = _both_maps(a, KF * N)
    alive = to_np(ms_t.lm_alive)
    gap = np.abs(to_np(ms_t.lm_pos)[:, alive] - np.asarray(ms_j.lm_pos)[:, alive])
    assert gap.max() <= 1e-5, gap.max()
    # features without depth adopted landmarks of the keyframe before
    assert (to_np(links.adopter) >= 0).sum() > 500


def test_lm_capacity_caps_the_map_as_jax():
    ms_j, ms_t, _ = _both_maps(_kf_inputs(0), 3000)
    assert ms_t.lm_pos.shape == (3, 3000 + N)
    assert int(ms_t.next_lm) == 3000 and int(ms_t.lm_dropped) > 5000


# ---------------------------------------------------------------- API


def test_orb_memo_is_exact():
    """Frames extracted one at a time, then served together, equal the
    extraction of the two as one chunk."""
    grays = torch.from_numpy(sequence(48, 13, 24)[0][[5, 0]].copy())
    memo = OrbMemo(TOP)
    memo(grays[1:], n_slots=1024)
    memo(grays[:1], n_slots=1024)
    for x, y in zip(memo(grays, n_slots=1024), orb_extract(grays, n_slots=1024)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("rows", ["pairs", "frames"])
def test_chunked_lanes_meet_the_single_run_batches(rows):
    """Each folded lane's rows go through the same batches as a single run
    of the lane (batched decompositions round by their batch), and the
    pairs across lanes through one more; the result is in row order."""
    B, L, chunk = 3, 11, 4
    M = B * L - 1 if rows == "pairs" else B * L
    calls = []

    def fn(x):
        calls.append(x.tolist())
        return (x * 2,)

    x = torch.arange(M)
    (y,) = TOP._chunked(fn, chunk, x, lanes=B)
    assert torch.equal(y, 2 * x)
    n = L - 1 if rows == "pairs" else L
    single = [list(range(i, min(i + chunk, n))) for i in range(0, n, chunk)]
    for b in range(B):
        assert calls[b * len(single):(b + 1) * len(single)] == [
            [b * L + r for r in c] for c in single]
    across = calls[B * len(single):]
    assert across == ([[L - 1, 2 * L - 1]] if rows == "pairs" else [])


def _kw_names(fn, skip=()):
    return {p.name for p in inspect.signature(fn).parameters.values()
            if p.name not in skip}


@pytest.mark.parametrize("name", ["build_offline_pipeline", "build_keyframe_map",
                                  "_link_consecutive_keyframes"])
def test_keyword_names_match_jax(name):
    names_j = _kw_names(getattr(JOP, name),
                        {"cam_static_placeholder", "takeover", "retriangulate"})
    assert _kw_names(getattr(TOP, name)) == names_j
