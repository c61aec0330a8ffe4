"""Sensor-degradation models (a copy of ``visionx_slam_tpu/data/degrade.py``;
equal bits on equal generators).

Every accuracy number rests on the synthetic renderer. This module degrades
rendered frames with the sensor effects a real fr1/fr2/fr3 capture carries,
matching the data model of the reference loader (depth PNGs at scale 5000
with zero-valued holes, core/common/dataset_tum_rgbd.cpp:124-165 optics;
exposure variation between frames; motion blur), so the pipeline's
robustness to them is measurable without the dataset.

All functions are numpy, host-side (they model the SENSOR, which runs
before the device pipeline).
"""

from __future__ import annotations

import numpy as np

TUM_DEPTH_SCALE = 5000.0  # dataset_tum_rgbd semantics; tracking.cpp:603


def quantize_depth(depth_m: np.ndarray) -> np.ndarray:
    """16-bit PNG depth quantization at the TUM factor (1/5000 m steps,
    saturating at the uint16 ceiling like a real file would)."""
    q = np.round(depth_m * TUM_DEPTH_SCALE)
    q = np.clip(q, 0, 65535).astype(np.uint16)
    return q.astype(np.float32) / TUM_DEPTH_SCALE


def depth_holes(depth_m: np.ndarray, rng: np.random.Generator,
                hole_frac: float = 0.15, blob_px: int = 16) -> np.ndarray:
    """Zero out blob-shaped regions (structured-light dropouts): low-res
    uniform noise upsampled to frame size, thresholded at ``hole_frac``.
    Kinect-style holes are spatially coherent, not salt-and-pepper."""
    out = depth_m.copy()
    T, H, W = depth_m.shape
    h, w = -(-H // blob_px), -(-W // blob_px)
    noise = rng.uniform(size=(T, h, w)).astype(np.float32)
    up = np.repeat(np.repeat(noise, blob_px, axis=1), blob_px, axis=2)
    out[up[:, :H, :W] < hole_frac] = 0.0
    return out


def depth_noise(depth_m: np.ndarray, rng: np.random.Generator,
                rel_sigma: float = 0.01) -> np.ndarray:
    """Multiplicative depth noise growing with range (Kinect error is
    ~quadratic in z; a z-proportional sigma is the conservative linear
    bound at room scale)."""
    n = rng.normal(0.0, rel_sigma, size=depth_m.shape).astype(np.float32)
    out = depth_m * (1.0 + n * np.clip(depth_m / 3.0, 0.3, 2.0))
    return np.where(depth_m > 0, np.maximum(out, 0.0), 0.0)


def exposure_jitter(gray_u8: np.ndarray, rng: np.random.Generator,
                    gain_range: float = 0.25,
                    bias_range: float = 12.0) -> np.ndarray:
    """Per-frame gain/bias (auto-exposure hunting between frames)."""
    T = gray_u8.shape[0]
    gain = 1.0 + rng.uniform(-gain_range, gain_range, size=(T, 1, 1))
    bias = rng.uniform(-bias_range, bias_range, size=(T, 1, 1))
    out = gray_u8.astype(np.float32) * gain + bias
    return np.clip(out, 0, 255).astype(np.uint8)


def motion_blur(gray_u8: np.ndarray, length: int = 5,
                axis: int = 2) -> np.ndarray:
    """Box blur along one image axis (handheld motion smear). ``length``
    odd; axis 2 = horizontal (the dominant direction of an orbiting
    handheld camera)."""
    assert length % 2 == 1
    g = gray_u8.astype(np.float32)
    k = length // 2
    acc = np.zeros_like(g)
    for d in range(-k, k + 1):
        acc += np.roll(g, d, axis=axis)
    return np.clip(acc / length, 0, 255).astype(np.uint8)


DEGRADATIONS = {
    "depth_quantized": lambda g, d, rng: (g, quantize_depth(d)),
    "depth_holes": lambda g, d, rng: (g, depth_holes(d, rng)),
    "depth_noise": lambda g, d, rng: (g, depth_noise(d, rng)),
    "exposure_jitter": lambda g, d, rng: (exposure_jitter(g, rng), d),
    "motion_blur": lambda g, d, rng: (motion_blur(g), d),
}


def degrade_all(gray_u8: np.ndarray, depth_m: np.ndarray,
                rng: np.random.Generator):
    """Every degradation stacked (the realistic combined sensor)."""
    g, d = gray_u8, depth_m
    for fn in DEGRADATIONS.values():
        g, d = fn(g, d, rng)
    return g, d
