"""Shared helpers of the ``test_torch_*`` parity tests: inputs are made with
numpy from a seed and handed to both the JAX package and the port."""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from visionx_slam_torch.data import synthetic

# One intra-op thread per test process. The suite runs several pytest
# workers at once; with torch's default of one OpenMP thread per core in
# each of them the cores are oversubscribed many times over and the
# spinning threads make every small op crawl (six concurrent 20-frame CPU
# runs of the port: 375 s with the default, 15 s with one thread each). The
# port's CPU path is a chain of small ops, which gain nothing from threads.
torch.set_num_threads(1)
SINGLE_THREAD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@functools.lru_cache(maxsize=4)
def sequence(n_frames: int, seed: int, frames_per_loop: int = 240):
    """(grays u8, depths f32, gt_t) of a synthetic 640x480 sequence."""
    return synthetic.make_sequence(n_frames, seed=seed,
                                   frames_per_loop=frames_per_loop)


def cameras():
    """(JAX camera, port camera) with the synthetic intrinsics."""
    from visionx_slam_tpu.ops.camera import make_camera as jax_camera

    from visionx_slam_torch.ops.camera import make_camera

    args = (synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    return jax_camera(*args), make_camera(*args)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t(x, dtype=None) -> torch.Tensor:
    """numpy -> CPU tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


class OrbMemo:
    """A stand-in for ``orb_extract`` in a module's namespace that extracts
    each distinct frame once (keyed by its bytes) and serves it from then
    on: the ORB of a frame does not depend on the other frames of its chunk
    (``test_orb_memo_is_exact``), so pipelines run several times over the
    same frames, in any order, see what ``orb_extract`` would return, and
    a CPU test pays for each frame once."""

    def __init__(self, module):
        self.module = module
        self.real = module.orb_extract
        self.cache: dict = {}

    def __call__(self, images: torch.Tensor, **kw):
        keys = [(hashlib.sha1(im.cpu().numpy().tobytes()).hexdigest(),
                 tuple(sorted(kw.items()))) for im in images]
        miss = [i for i, k in enumerate(keys) if k not in self.cache]
        if miss:
            out = self.real(images[miss], **kw)
            for j, i in enumerate(miss):
                self.cache[keys[i]] = tuple(x[j] for x in out)
        return tuple(torch.stack([self.cache[k][f] for k in keys]) for f in range(4))

    def __enter__(self):
        self.module.orb_extract = self
        return self

    def __exit__(self, *exc):
        self.module.orb_extract = self.real
