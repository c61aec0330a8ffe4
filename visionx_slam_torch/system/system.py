"""Map snapshots, the keyframe archive and the full-map global BA
(counterparts of what ``visionx_slam_tpu/system/system.py`` keeps inside its
``System`` class: ``save_snapshot`` / ``load_snapshot_full``,
``_harvest_keyframes``, ``_archive_union_map``, ``_run_global_ba`` and the
chunked scan loop of ``_run_scan``), as plain functions. The ``System``
class itself (dataset, configuration, outputs, the CLI behind it) is not
ported yet; it will call these.

A snapshot is a flat npz: one array per ``MapState`` field under the field's
name, with the JAX package's shapes and dtypes, plus ``_meta_*`` entries
(``_meta_next_frame_id``: the frame id a resumed run continues at). Either
package loads the other's file.

The archive is a host dict ``frame id -> keyframe observations`` (numpy):
the online scan keeps only the last ``kf_capacity`` keyframes in its ring,
so a run that wants a global BA over every keyframe it ever made harvests
the ring at chunk boundaries, with chunks no longer than the ring.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import mapstate_from_numpy, mapstate_to_numpy
from ..models.global_ba import GlobalBAOptions, global_ba, map_reproj_error
from ..models.pair_ba import pair_ba
from ..ops.camera import CameraParams
from ..ops.se3 import Pose, se3_matrix
from ..tracking import mapstate as msl
from ..tracking.mapstate import MapState, PairLinks
from ..tracking.offline_pipeline import build_keyframe_map
from ..tracking.scan_pipeline import (
    FrameOut,
    ScanState,
    resume_state,
    run_scan_pipeline,
)
from ..utils.config import TrackingOptions


def save_snapshot(path: str, ms: MapState, next_frame_id: int) -> None:
    """Write the map checkpoint ``path`` (npz); ``next_frame_id``: the id
    of the first frame a resumed run will process."""
    np.savez_compressed(
        path, _meta_next_frame_id=np.asarray(next_frame_id, np.int64),
        **mapstate_to_numpy(ms))


def load_snapshot_full(path: str, device="cuda") -> tuple[MapState, dict]:
    """(MapState on ``device``, meta dict) from a snapshot npz."""
    z = np.load(path)
    meta = {k[len("_meta_"):]: z[k].item()
            for k in z.files if k.startswith("_meta_")}
    return mapstate_from_numpy({k: z[k] for k in MapState._fields}, device), meta


def load_snapshot(path: str, device="cuda") -> MapState:
    return load_snapshot_full(path, device)[0]


def harvest_keyframes(archive: dict, ms: MapState) -> dict:
    """Copy the alive keyframes of ``ms`` that ``archive`` does not hold yet
    to the host (one device-to-host copy of the keyframe tables, whatever
    the number of new keyframes); returns ``archive``."""
    kf = {f: getattr(ms, f).cpu().numpy() for f in
          ("kf_id", "kf_q", "kf_t", "kf_px", "kf_desc", "kf_fvalid", "kf_depth")}
    for slot in np.flatnonzero(kf["kf_id"] >= 0):
        fid = int(kf["kf_id"][slot])
        if fid in archive:
            continue
        archive[fid] = {
            "q": kf["kf_q"][slot].copy(), "t": kf["kf_t"][slot].copy(),
            "px": kf["kf_px"][slot].T.copy(),               # [N,2]
            "desc": kf["kf_desc"][slot].copy(),
            "fvalid": kf["kf_fvalid"][slot].copy(),
            "depth": kf["kf_depth"][slot].copy(),
        }
    return archive


def archive_union_map(archive: dict, cam: CameraParams, opts: TrackingOptions,
                      device="cuda") -> tuple[MapState, PairLinks]:
    """A (MapState, PairLinks) over every archived keyframe, ids ascending,
    by the offline pipeline's ``build_keyframe_map`` (depth landmarks and
    consecutive-pair observation links). The keyframe slots are padded to a
    power of two >= 8 and the landmark table holds at least 1 << 17 rows."""
    fids = sorted(archive)
    K = max(8, 1 << (len(fids) - 1).bit_length())
    N = archive[fids[0]]["px"].shape[0]

    def pad(key, fill=0.0, dtype=np.float32):
        arrs = [archive[f][key] for f in fids]
        out = np.full((K,) + arrs[0].shape, fill, dtype)
        out[:len(arrs)] = np.stack(arrs)
        return out

    kf_q = pad("q")
    kf_q[len(fids):, 0] = 1.0
    kf_id = np.full((K,), -1, np.int32)
    kf_id[:len(fids)] = fids
    dev = torch.device(device)
    on = lambda x: torch.from_numpy(x).to(dev)
    return build_keyframe_map(
        cam, opts, on(kf_q), on(pad("t")), on(kf_id), on(pad("px")),
        on(pad("desc", 0, np.uint8)), on(pad("fvalid", False, bool)),
        on(pad("depth")), 1 << max(17, (K * N - 1).bit_length()))


def run_global_ba(ms: MapState, cam: CameraParams, opts: TrackingOptions,
                  archive: dict | None = None, iterations: int = 10,
                  device="cuda") -> tuple[MapState, dict]:
    """Full-map Schur-complement BA (BASELINE config 4). When ``archive``
    holds more keyframes than the ring of ``ms`` (it is first topped up from
    ``ms``), the solve covers the union map of every archived keyframe with
    ``pair_ba`` (that map has the pairwise link structure); otherwise it is
    ``global_ba`` on ``ms``, whose observation graph is general. Returns
    (refined map, summary): iterations, final cost, observations, the mean
    reprojection error before and after, ``archived_keyframes`` (union
    solves only), and the refined keyframes in frame-id order as
    ``keyframe_ids`` and ``keyframe_poses`` [n,4,4] T_cw (numpy)."""
    extra = {}
    links = None
    if archive is not None and len(archive) > int(msl.n_keyframes(ms)):
        harvest_keyframes(archive, ms)             # the last chunk's keyframes
        ms, links = archive_union_map(archive, cam, opts, device)
        extra["archived_keyframes"] = len(archive)
    err0, _ = map_reproj_error(ms, cam)
    gba_opts = GlobalBAOptions(max_iterations=iterations)
    if links is not None:
        ms2, stats = pair_ba(ms, cam, links, gba_opts)
    else:
        ms2, stats = global_ba(ms, cam, gba_opts)
    err1, _ = map_reproj_error(ms2, cam)
    kf_ids = ms2.kf_id.cpu().numpy()
    slots = np.flatnonzero(kf_ids >= 0)
    slots = slots[np.argsort(kf_ids[slots], kind="stable")]
    at = torch.from_numpy(slots).to(ms2.kf_q.device)
    poses = se3_matrix(Pose(ms2.kf_q[at], ms2.kf_t[at])).cpu().numpy()
    return ms2, {
        "iterations": int(stats.iterations),
        "final_cost": float(stats.final_cost),
        "total_obs": int(stats.total_obs),
        "mean_reproj_before_px": float(err0),
        "mean_reproj_after_px": float(err1),
        "keyframe_ids": kf_ids[slots].tolist(),
        "keyframe_poses": poses,
        **extra,
    }


def run_scan_archived(
    cam: CameraParams,
    images_u8,               # [T,H,W] uint8 (tensor or numpy)
    depths_m,                # [T,H,W] float32
    opts: TrackingOptions,
    kf_capacity: int = 64,
    n_features_cap: int = 1024,
    lm_capacity: int = 1 << 17,
    orb_kwargs: dict | None = None,
    run_gba: bool = True,
    gba_iterations: int = 10,
    resume_from: str | None = None,
    device="cuda",
    stats: dict | None = None,
) -> tuple[ScanState, FrameOut, dict, dict | None]:
    """The online scan over a whole sequence in chunks of ``min(64,
    kf_capacity)`` frames, the state streamed from chunk to chunk, with the
    keyframe archive harvested at every chunk boundary (a chunk no longer
    than the ring cannot create and evict a keyframe between two harvests)
    and, with ``run_gba``, the full-map global BA at the end.
    ``resume_from``: a snapshot npz to continue from (frame ids go on at its
    ``next_frame_id``). Returns (final state, FrameOut over all frames,
    archive, global-BA summary or None); with ``run_gba`` the final state's
    map is the refined one (the union map when the archive outgrew the
    ring). ``stats``: if a dict is given, it receives the chunks' counters
    summed and the harvests' host seconds."""
    import time

    dev = torch.device(device)
    images = torch.as_tensor(images_u8)
    depths = torch.as_tensor(depths_m)
    T = images.shape[0]
    chunk = min(64, kf_capacity)
    st, frame0 = None, 0
    if resume_from:
        ms0, meta = load_snapshot_full(resume_from, dev)
        st = resume_state(ms0)
        frame0 = int(meta.get("next_frame_id", 0))
    archive: dict = {}
    outs, totals, harvest_s = [], {}, 0.0
    for s in range(0, T, chunk):
        cs: dict = {}
        st, out = run_scan_pipeline(
            cam, images[s:s + chunk], depths[s:s + chunk], opts,
            n_features_cap=n_features_cap, kf_capacity=kf_capacity,
            lm_capacity=lm_capacity, orb_kwargs=orb_kwargs, st0=st,
            frame0=frame0 + s, device=dev, stats=cs)
        outs.append(out)
        for k, v in cs.items():
            if isinstance(v, (int, float)):
                totals[k] = totals.get(k, 0) + v
        t0 = time.perf_counter()
        harvest_keyframes(archive, st.ms)
        harvest_s += time.perf_counter() - t0
    out = FrameOut(*(torch.cat(x) for x in zip(*outs)))
    gba = None
    if run_gba and st is not None:
        ms2, gba = run_global_ba(st.ms, cam, opts, archive, gba_iterations, dev)
        st = st._replace(ms=ms2)
    if stats is not None:
        stats.update(totals, chunks=len(outs), chunk=chunk,
                     harvest_seconds=harvest_s)
    return st, out, archive, gba
