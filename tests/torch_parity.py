"""Shared helpers of the ``test_torch_*`` parity tests: inputs are made with
numpy from a seed and handed to both the JAX package and the port."""

from __future__ import annotations

import functools

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
