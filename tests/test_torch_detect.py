"""K1's plain PyTorch version against the JAX package's detector — the
Pallas kernel in interpret mode and the XLA path — and the CUDA kernel
against the plain version on the card (skipped without one); likewise the
score-only wrapper K1b (``fast_harris_score``).

Tolerances are those of tests/test_pallas_detect.py: corner-mask agreement
> 0.99 inside the detection border; score rtol 2e-2, atol 20 (the kernels
associate the bf16 box sums differently); blur rtol 2e-2, atol 2. On the
card the kernels must equal their plain versions bit for bit, at the
rendered 8-frame atlas and at the edge shapes of ``k1_bench.EDGE_SHAPES``
(odd W, H below one row band, one row past a band); the plain version is
held to the Pallas kernel at those edge shapes on the CPU.

The JAX package is imported by a fixture, not at module level, so that the
CUDA test also runs on a GPU host without jax (see README: it runs there
with ``--noconftest``, since tests/conftest.py imports jax).
"""

import types

import numpy as np
import pytest
import torch

from visionx_slam_torch.models.orb_torch import build_atlas
from visionx_slam_torch.ops import detect
from visionx_slam_torch.tools import k1_bench

from torch_parity import sequence, t, to_np

B = 31  # detection border


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jnp, Pallas' TPU module, orb_jax and pallas_detect."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from visionx_slam_tpu.models import orb_jax
    from visionx_slam_tpu.ops import pallas_detect

    return types.SimpleNamespace(jnp=jnp, pltpu=pltpu, OJ=orb_jax,
                                 PD=pallas_detect)


@pytest.fixture(scope="module")
def img():
    # the image of tests/test_pallas_detect.py
    rng = np.random.default_rng(3)
    cells = rng.uniform(30, 220, size=(16, 20))
    im = np.kron(cells, np.ones((8, 8)))[:120, :160]
    im = im + rng.uniform(-1, 1, size=im.shape)
    return np.clip(im, 0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def atlas():
    grays, _, _ = sequence(2, 5)
    a, m = build_atlas(t(grays[:1]))
    return a, m


def _plain(img16: torch.Tensor, mask: torch.Tensor):
    s, b = detect.fast_harris_blur(img16.contiguous(), mask.contiguous())
    return to_np(s[0]), to_np(b[0].float())


def _inner(a, b):
    return a[b:a.shape[0] - b, b:a.shape[1] - b]


def _check(score_t, score_r, ok_r, blur_t=None, blur_r=None, b=B, bb=8):
    st, sr = _inner(score_t, b), _inner(score_r, b)
    mt, mr = st > 0.5 * detect.NEG, _inner(ok_r, b)
    agree = (mt == mr).mean()
    assert agree > 0.99, f"corner mask agreement {agree:.4f}"
    both = mt & mr
    assert both.sum() > 20
    np.testing.assert_allclose(st[both], sr[both], rtol=2e-2, atol=20.0)
    if blur_t is not None:
        np.testing.assert_allclose(_inner(blur_t, bb), _inner(blur_r, bb),
                                   rtol=2e-2, atol=2.0)


def _jax_inputs(jx, a16: np.ndarray, mask: np.ndarray):
    return jx.jnp.asarray(a16).astype(jx.jnp.bfloat16), jx.jnp.asarray(mask)


def _xla_score(jx, a16: np.ndarray, mask: np.ndarray):
    """orb_jax's dense passes: (score, candidate mask); -inf off-corner."""
    jnp, OJ = jx.jnp, jx.OJ
    j16 = jnp.asarray(a16).astype(jnp.bfloat16)
    corners = OJ._fast_corners(j16, jnp.bfloat16(20.0))
    harris = OJ._harris(j16).astype(jnp.float32)
    cand = corners & OJ._nms3(jnp.where(corners, harris, -jnp.inf))
    cand = cand & jnp.asarray(mask != 0)
    return np.asarray(jnp.where(cand, harris, -jnp.inf)), np.asarray(cand)


def test_plain_matches_pallas_interpret_image(jx, img):
    a16 = t(img).to(torch.bfloat16)[None]
    mask = torch.ones(img.shape, dtype=torch.int8)
    s_t, b_t = _plain(a16, mask)
    with jx.pltpu.force_tpu_interpret_mode():
        s_p, b_p = jx.PD.fast_harris_blur(*_jax_inputs(jx, img, to_np(mask)), 20.0)
    s_p = np.asarray(s_p)
    _check(s_t, s_p, s_p > 0.5 * jx.PD.NEG, b_t,
           np.asarray(b_p.astype(jx.jnp.float32)))


def test_plain_matches_pallas_interpret_atlas(jx, atlas):
    """On a rendered atlas the Pallas kernel in interpret mode keeps excess
    precision in its bf16 box sums, and where det - k tr^2 cancels it
    leaves the stated score tolerance at a few corners — the same corners
    at which the JAX package's own XLA path leaves it. So: mask agreement
    and blur as stated, and the port may miss the score tolerance only
    where the XLA path misses it too."""
    a16, mask = atlas
    s_t, b_t = _plain(a16, mask)
    a_np, m_np = to_np(a16[0].float()), to_np(mask)
    with jx.pltpu.force_tpu_interpret_mode():
        s_p, b_p = jx.PD.fast_harris_blur(*_jax_inputs(jx, a_np, m_np), 20.0)
    s_p = np.asarray(s_p)
    np.testing.assert_allclose(
        b_t[8:-8, 8:-8], np.asarray(b_p.astype(jx.jnp.float32))[8:-8, 8:-8],
        rtol=2e-2, atol=2.0)
    s_x, c_x = _xla_score(jx, a_np, m_np)
    inner = np.zeros_like(c_x)
    inner[B:-B, B:-B] = True
    c_t, c_p = (s_t > 0.5 * detect.NEG) & inner, (s_p > 0.5 * jx.PD.NEG) & inner
    agree = (c_t == c_p)[inner].mean()
    assert agree > 0.99, f"corner mask agreement {agree:.4f}"
    both = c_t & c_p & c_x
    assert both.sum() > 1000

    def misses(s):
        return np.abs(s - s_p) > 20.0 + 2e-2 * np.abs(s_p)

    miss_t, miss_x = misses(s_t) & both, misses(s_x) & both
    assert miss_t.sum() <= 1e-2 * both.sum()
    assert not (miss_t & ~miss_x).any(), np.argwhere(miss_t & ~miss_x)


@pytest.mark.parametrize("source", ["image", "atlas"])
def test_plain_matches_xla_path(jx, source, img, atlas):
    """Against orb_jax's dense passes (FAST in bf16, roll-wrapped shifts:
    they differ from the kernels only under the border)."""
    if source == "image":
        a16 = t(img).to(torch.bfloat16)[None]
        mask = torch.ones(img.shape, dtype=torch.int8)
    else:
        a16, mask = atlas
    s_t, b_t = _plain(a16, mask)
    a_np = to_np(a16[0].float())
    s_x, c_x = _xla_score(jx, a_np, to_np(mask))
    jnp = jx.jnp
    blur_x = jx.OJ._sep_conv(jnp.asarray(a_np).astype(jnp.bfloat16),
                             jx.OJ._gaussian_kernel1d()).astype(jnp.float32)
    _check(s_t, s_x, c_x, b_t, np.asarray(blur_x))


def _plain_batch(img16, mask):
    s, b = detect.fast_harris_blur_reference(img16, mask)
    return to_np(s), to_np(b.float())


@pytest.mark.parametrize("shape", k1_bench.EDGE_SHAPES, ids=str)
def test_plain_matches_pallas_interpret_edge_shapes(jx, shape):
    """At the shapes the kernel's tiling must get right (numpy-seeded noise
    and a random border mask), every frame of the plain version against the
    Pallas kernel in interpret mode, both edge-padded: borders included."""
    img16, mask, _ = k1_bench.edge_inputs(shape, k1_bench.EDGE_SHAPES.index(shape))
    s_t, b_t = _plain_batch(img16, mask)
    for f in range(shape[0]):
        with jx.pltpu.force_tpu_interpret_mode():
            s_p, b_p = jx.PD.fast_harris_blur(
                *_jax_inputs(jx, to_np(img16[f].float()), to_np(mask)), 20.0)
        s_p = np.asarray(s_p)
        _check(s_t[f], s_p, s_p > 0.5 * jx.PD.NEG, b_t[f],
               np.asarray(b_p.astype(jx.jnp.float32)), b=0, bb=0)


def test_score_plain_matches_pallas_interpret_2d(jx):
    """K1b's plain version on a 2-D float32 image that is not bf16-exact
    against ``pallas_detect.fast_harris_score`` in interpret mode."""
    _, _, img32 = k1_bench.edge_inputs(k1_bench.EDGE_SHAPES[0], 0)
    s_t = to_np(detect.fast_harris_score_reference(img32[0]))
    with jx.pltpu.force_tpu_interpret_mode():
        s_p = np.asarray(jx.PD.fast_harris_score(jx.jnp.asarray(to_np(img32[0])), 20.0))
    assert s_t.shape == s_p.shape == tuple(img32.shape[1:])
    _check(s_t, s_p, s_p > 0.5 * jx.PD.NEG, b=0)


def test_wrapper_checks_its_inputs():
    img16 = torch.zeros((1, 40, 48), dtype=torch.bfloat16)
    mask = torch.ones((40, 48), dtype=torch.int8)
    with pytest.raises(ValueError):
        detect.fast_harris_blur(img16.float(), mask)
    with pytest.raises(ValueError):
        detect.fast_harris_blur(img16, mask[:-1])
    with pytest.raises(ValueError):
        detect.fast_harris_blur(img16[:, :, ::2], mask[:, :24])
    before = detect.launches
    s, b = detect.fast_harris_blur(img16, mask)   # CPU: plain version
    assert s.shape == (1, 40, 48) and b.dtype == torch.bfloat16
    assert detect.launches == before              # no kernel launch on CPU


def test_score_plain_matches_pallas_interpret(jx, img):
    """K1b's plain version against ``pallas_detect.fast_harris_score`` in
    interpret mode (as tests/test_pallas_detect.py runs it), and the CPU
    wrapper takes the plain version without a launch."""
    s_t = to_np(detect.fast_harris_score_reference(t(img)))
    with jx.pltpu.force_tpu_interpret_mode():
        s_p = np.asarray(jx.PD.fast_harris_score(jx.jnp.asarray(img), 20.0))
    assert s_t.shape == img.shape
    _check(s_t, s_p, s_p > 0.5 * jx.PD.NEG)
    before = (detect.launches, detect.score_launches)
    s_w = detect.fast_harris_score(t(img)[None])
    assert (detect.launches, detect.score_launches) == before
    np.testing.assert_array_equal(to_np(s_w[0]), s_t)
    with pytest.raises(ValueError):
        detect.fast_harris_score(t(img).to(torch.uint8))


@pytest.fixture(scope="module")
def cuda_cases():
    """The exact-check cases on the card: the rendered 8-frame atlas of the
    main path's chunk, [8,1896,640], and the edge shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 and K1b have no CPU mode)")
    grays, _, _ = sequence(8, 5)
    return k1_bench.exact_cases(*build_atlas(t(grays).cuda()))


@pytest.mark.cuda
def test_cuda_score_kernel_matches_plain(img, cuda_cases):
    """K1b equals its plain version bit for bit, in one launch per call."""
    for name, x in cuda_cases[1] + [("image", t(img).cuda()), ("image 3-D", t(img)[None].cuda())]:
        before = (detect.launches, detect.score_launches)
        s_k = detect.fast_harris_score(x)
        assert (detect.launches, detect.score_launches) == (before[0], before[1] + 1)
        s_p = detect.fast_harris_score_reference(x)
        assert s_k.shape == x.shape, name
        assert torch.equal(s_k.view(torch.int32), s_p.view(torch.int32)), name
        k, p = to_np(s_k.reshape(-1, *x.shape[-2:])[0]), to_np(s_p.reshape(-1, *x.shape[-2:])[0])
        if min(k.shape) > 64:
            _check(k, p, p > 0.5 * detect.NEG, b=8)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(img, cuda_cases):
    """K1 equals its plain version bit for bit: score as f32 bits, blur as
    bf16 bits."""
    image = ("image", t(img).to(torch.bfloat16)[None].cuda(),
             torch.ones(img.shape, dtype=torch.int8).cuda())
    for name, x, m in cuda_cases[0] + [image]:
        before = detect.launches
        s_k, b_k = detect.fast_harris_blur(x, m)
        assert detect.launches == before + 1
        s_p, b_p = detect.fast_harris_blur_reference(x, m)
        assert torch.equal(s_k.view(torch.int32), s_p.view(torch.int32)), name
        assert torch.equal(b_k.view(torch.int16), b_p.view(torch.int16)), name
        if min(x.shape[1:]) > 64:
            _check(to_np(s_k[0]), to_np(s_p[0]), to_np(s_p[0]) > 0.5 * detect.NEG,
                   to_np(b_k[0].float()), to_np(b_p[0].float()))
