"""splice_tpu_torch.ops.image against splice_tpu.ops.image.

Every random draw is given to both sides (crop side and corners, jitter
factors and order, flip and blur coins, sigma). fp32; values rtol 1e-5
with atol 1e-6 (pixel values are in [0, 1]), gradients rtol 1e-4. The
resampling tests allow atol 5e-6: jax.image.resize on the CPU deviates from
a float64 evaluation of its own weight matrices by up to 3.5e-6, the port
by 1e-7 (the weight matrices themselves agree exactly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splice_tpu.ops import image as jimg
from splice_tpu_torch.ops import image as timg


def _img(h, w, seed, batch=None):
    shape = (h, w, 3) if batch is None else (batch, h, w, 3)
    return np.random.default_rng(seed).random(shape).astype(np.float32)


RESAMPLE_ATOL = 5e-6


def _close(t, j, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("hw", [(900, 1200), (1200, 900), (896, 896),
                                (70, 90), (982, 1280), (100, 1000)])
def test_dino_resize_shape(hw):
    assert timg.dino_resize_shape(*hw) == jimg.dino_resize_shape(*hw)


@pytest.mark.parametrize("out_hw", [(32, 41), (64, 64), (80, 100)])
def test_resize_down_and_up(out_hw):
    x = _img(64, 82, seed=1, batch=2)
    _close(timg.resize(torch.from_numpy(x), out_hw),
           jimg.resize(jnp.asarray(x), out_hw), atol=RESAMPLE_ATOL)


def test_dino_global_resize_and_normalize_value_and_grad():
    x = _img(70, 90, seed=2, batch=2)
    w = np.random.default_rng(3).standard_normal((2, 32, 41, 3)).astype(
        np.float32)

    def jf(a):
        y = jimg.imagenet_normalize(jimg.dino_global_resize(a, 32, 480))
        return jnp.sum(y * w)

    tx = torch.from_numpy(x).requires_grad_(True)
    ty = timg.imagenet_normalize(timg.dino_global_resize(tx, 32, 480))
    assert ty.shape == (2, 32, 41, 3)
    (ty * torch.from_numpy(w)).sum().backward()
    _close(ty, jimg.imagenet_normalize(
        jimg.dino_global_resize(jnp.asarray(x), 32, 480)),
           atol=RESAMPLE_ATOL / 0.224)
    _close(tx.grad, jax.grad(jf)(jnp.asarray(x)), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("top,left,side", [(0.0, 0.0, 60.0),
                                           (7.0, 23.0, 63.0),
                                           (10.0, 30.0, 40.0)])
def test_crop_and_resize_given_draws(top, left, side):
    x = _img(70, 90, seed=4)
    _close(timg.crop_and_resize(torch.from_numpy(x), top, left, side, 64),
           jimg.crop_and_resize(jnp.asarray(x), top, left, side, 64),
           atol=RESAMPLE_ATOL)


def test_global_crops_given_draws():
    x = _img(70, 90, seed=5)
    side, tops, lefts = 66.0, [1.0, 4.0], [0.0, 24.0]
    got = timg.global_crops(torch.from_numpy(x), side, tops, lefts, 64)
    want = jnp.stack([jimg.crop_and_resize(jnp.asarray(x), t, l, side, 64)
                      for t, l in zip(tops, lefts)])
    assert got.shape == (2, 64, 64, 3)
    _close(got, want, atol=RESAMPLE_ATOL)


def test_sample_crop_draws_follow_the_reference_formula():
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        side, tops, lefts = timg.sample_crop_draws(70, 90, 3, 0.95, gen)
        assert round(0.95 * 70) <= side <= 70 and side == int(side)
        assert all(0 <= t <= 70 - side and t == int(t) for t in tops)
        assert all(0 <= l <= 90 - side and l == int(l) for l in lefts)


@pytest.mark.parametrize("order", [(0, 1, 2, 3), (3, 2, 1, 0), (2, 0, 3, 1)])
def test_color_jitter_given_factors_and_order(order):
    x = _img(20, 24, seed=6)
    factors = (1.3, 0.7, 1.15, -0.07)
    ops = (jimg.adjust_brightness, jimg.adjust_contrast,
           jimg.adjust_saturation, jimg.adjust_hue)
    want = jnp.asarray(x)
    for op in order:
        want = ops[op](want, factors[op])
    _close(timg.color_jitter(torch.from_numpy(x), factors, order), want)


def test_sample_jitter_draws_ranges():
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        (fb, fc, fs, fh), order = timg.sample_jitter_draws(gen)
        assert 0.6 <= fb <= 1.4 and 0.6 <= fc <= 1.4
        assert 0.8 <= fs <= 1.2 and -0.1 <= fh <= 0.1
        assert sorted(order) == [0, 1, 2, 3]


@pytest.mark.parametrize("sigma", [0.1, 0.9, 2.0])
def test_gaussian_blur3(sigma):
    x = _img(17, 23, seed=7)
    _close(timg.gaussian_blur3(torch.from_numpy(x), sigma),
           jimg.gaussian_blur3(jnp.asarray(x), jnp.float32(sigma)))


@pytest.mark.parametrize("flip", [False, True])
def test_flip_and_structure_augment(flip):
    x = _img(16, 20, seed=8)
    factors, order = (1.2, 0.8, 1.1, 0.05), (1, 3, 0, 2)
    got = timg.structure_augment(torch.from_numpy(x), flip, True, factors,
                                 order, True, 0.7)
    want = jnp.asarray(x)[:, ::-1] if flip else jnp.asarray(x)
    for op in order:
        want = (jimg.adjust_brightness, jimg.adjust_contrast,
                jimg.adjust_saturation, jimg.adjust_hue)[op](want,
                                                             factors[op])
    want = jimg.gaussian_blur3(want, jnp.float32(0.7))
    _close(got, want)
    _close(timg.texture_augment(torch.from_numpy(x), flip),
           jnp.asarray(x)[:, ::-1] if flip else jnp.asarray(x))


def test_output_png_conversion_matches_reference():
    from splice_tpu.utils import io as jio
    from splice_tpu_torch.utils import io as tio
    x = _img(5, 6, seed=9) * 1.4 - 0.2
    np.testing.assert_array_equal(tio.tensor2im(torch.from_numpy(x)),
                                  jio.tensor2im(x))
    np.testing.assert_array_equal(tio.tensor2im(torch.from_numpy(x[None])),
                                  jio.tensor2im(x[None]))
