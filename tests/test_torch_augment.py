"""The port's device augmentation against the JAX package's, on the CPU.

JAX draws from a threefry key, which torch cannot reproduce, so each test
makes JAX's draws from the key exactly as ``vbt_tpu.train.augment`` splits
it and feeds them to the port's deterministic half. Tolerances:
``scale_and_translate`` within 1e-4 of ``jax.image.scale_and_translate`` on
float32 pixel values in [0, 255] (both sum the same triangle weights; the
order differs), at scales on both sides of 1 (below 1 the kernel widens);
the augmented images within 1e-3 (the JAX function computes its weights
in float64 under the tests' x64 and casts them to float32; the port
computes them in float32); boxes within 1e-4 and valid flags exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vbt_tpu.train import augment as ja  # noqa: E402
from vbt_tpu_torch.train import augment as ta  # noqa: E402

B, S, G = 8, 48, 3
IMG_ATOL, BOX_ATOL = 1e-3, 1e-4


@pytest.mark.parametrize("scale", [0.5, 0.73, 1.0, 1.37, 1.6])
def test_scale_and_translate_matches_jax(scale):
    rng = np.random.default_rng(int(scale * 100))
    img = rng.uniform(0, 255, size=(S, S + 8, 3)).astype(np.float32)
    sc = np.array([scale, scale * 0.9], np.float32)
    for shift in ([0.0, 0.0], [3.25, -7.5], [-(scale - 1) * S, 5.0]):
        t = np.array(shift, np.float32)
        want = jax.image.scale_and_translate(jnp.asarray(img), img.shape, (0, 1), jnp.asarray(sc),
                                             jnp.asarray(t), method="linear")
        got = ta.scale_and_translate(torch.from_numpy(img)[None], torch.from_numpy(sc)[None],
                                     torch.from_numpy(t)[None])[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def _marker_batch(seed=0):
    """Images with random texture and bright squares whose boxes are the
    ground truth; the last row of each image is invalid padding."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 60, size=(B, S, S, 3)).astype(np.uint8)
    boxes = np.zeros((B, G, 4), np.float32)
    valid = np.zeros((B, G), bool)
    for i in range(B):
        for j in range(G - 1):
            y0, x0 = rng.integers(2, S - 14, size=2)
            hh, ww = rng.integers(4, 12, size=2)
            imgs[i, y0:y0 + hh, x0:x0 + ww] = 250
            boxes[i, j] = [y0, x0, y0 + hh, x0 + ww]
            valid[i, j] = True
    return imgs, boxes, valid


def _jax_flip_jitter_draws(kf, kj, ks, kty, ktx, lo, hi, jitter_p):
    flip = jax.random.bernoulli(kf, 0.5, (B,))
    do_jit = jax.random.bernoulli(kj, jitter_p, (B,))
    scale = jnp.where(do_jit, jax.random.uniform(ks, (B,), minval=lo, maxval=hi), 1.0)
    span = S - scale * S
    ty = jax.random.uniform(kty, (B,)) * span
    tx = jax.random.uniform(ktx, (B,)) * span
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    f = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    return {"flip": t(flip), "do_jit": t(do_jit), "scale": f(scale), "ty": f(ty), "tx": f(tx)}


def jax_draws(key, lo=0.6, hi=1.4):
    """The draws ``augment_and_normalize`` makes from ``key``."""
    return ta.Draws(**_jax_flip_jitter_draws(*jax.random.split(key, 5), lo, hi, 0.5))


def jax_mosaic_draws(key, lo=0.5, hi=1.6, mosaic_p=0.5, jitter_p=0.5):
    """The draws ``augment_mosaic_and_normalize`` makes from ``key``."""
    km, ksel, kf, kj, ks, kty, ktx = jax.random.split(key, 7)
    kp, kc = jax.random.split(km)
    perms = jax.random.permutation(kp, B * 3).reshape(3, B) % B
    cy, cx = jnp.moveaxis(jax.random.uniform(kc, (B, 2), minval=0.3 * S, maxval=0.7 * S), -1, 0)
    use_m = jax.random.bernoulli(ksel, mosaic_p, (B,))
    f = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    return ta.Draws(**_jax_flip_jitter_draws(kf, kj, ks, kty, ktx, lo, hi, jitter_p),
                    use_m=torch.from_numpy(np.array(use_m)),
                    perms=torch.from_numpy(np.array(perms, np.int64)), cy=f(cy), cx=f(cx))


def _compare(got, want):
    images, boxes, valid = (np.asarray(w) for w in want)
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), images, atol=IMG_ATOL, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), valid)
    np.testing.assert_allclose(got[1].numpy(), boxes, atol=BOX_ATOL, rtol=0)


def _covers_both_sides(d):
    """Both flips, and scale jitter that shrinks and that zooms."""
    return bool(d.flip.any() and (~d.flip).any() and (d.scale < 1).any() and (d.scale > 1).any())


# Keys whose draws (under the tests' x64) cover both sides of scale 1.
@pytest.mark.parametrize("seed", [1, 3])
def test_flip_and_jitter_lane_matches_jax(seed):
    imgs, boxes, valid = _marker_batch(seed)
    key = jax.random.PRNGKey(seed)
    draws = jax_draws(key)
    assert _covers_both_sides(draws)
    want = ja.augment_and_normalize(jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(valid), key)
    _compare(ta.augment_and_normalize(torch.from_numpy(imgs), torch.from_numpy(boxes),
                                      torch.from_numpy(valid), draws), want)


@pytest.mark.parametrize("seed", [1, 2])
def test_mosaic_lane_matches_jax(seed):
    imgs, boxes, valid = _marker_batch(seed)
    key = jax.random.PRNGKey(seed)
    draws = jax_mosaic_draws(key)
    assert draws.use_m.any() and (~draws.use_m).any() and _covers_both_sides(draws)
    want = ja.augment_mosaic_and_normalize(jnp.asarray(imgs), jnp.asarray(boxes),
                                           jnp.asarray(valid), key)
    got = ta.augment_mosaic_and_normalize(torch.from_numpy(imgs), torch.from_numpy(boxes),
                                          torch.from_numpy(valid), draws)
    assert got[1].shape == (B, 4 * G, 4) and got[2].shape == (B, 4 * G)
    _compare(got, want)


def test_mosaic_p_zero_keeps_the_plain_lane():
    imgs, boxes, valid = _marker_batch(5)
    key = jax.random.PRNGKey(0)
    draws = jax_mosaic_draws(key, mosaic_p=0.0)
    assert not draws.use_m.any()
    want = ja.augment_mosaic_and_normalize(jnp.asarray(imgs), jnp.asarray(boxes),
                                           jnp.asarray(valid), key, mosaic_p=0.0)
    got = ta.augment_mosaic_and_normalize(torch.from_numpy(imgs), torch.from_numpy(boxes),
                                          torch.from_numpy(valid), draws)
    _compare(got, want)
    plain = ta._flip_jitter_normalize(torch.from_numpy(imgs).float(), torch.from_numpy(boxes),
                                      torch.from_numpy(valid), draws)
    torch.testing.assert_close(got[0], plain[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1][:, :G], plain[1], rtol=0, atol=0)
    assert not got[2][:, G:].any()


def test_draws_are_seeded_and_in_range():
    gen = torch.Generator().manual_seed(0)
    d = ta.draw_mosaic(gen, B, S, mosaic_p=0.5)
    d2 = ta.draw_mosaic(torch.Generator().manual_seed(0), B, S, mosaic_p=0.5)
    for a, b in zip(d, d2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert d.perms.shape == (3, B) and int(d.perms.max()) < B
    assert ((d.cy >= 0.3 * S) & (d.cy < 0.7 * S)).all()
    assert (d.scale[~d.do_jit] == 1).all()
    assert ((d.scale[d.do_jit] >= 0.5) & (d.scale[d.do_jit] < 1.6)).all()
