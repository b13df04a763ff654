"""Device-side training augmentation.

Port of ``vbt_tpu.train.augment``. Raw uint8 batches cross to the device
once; flip, scale jitter, the 4-image mosaic and normalization run there.

Each augmentation is split in two: a ``draw_*`` function makes every random
choice from a ``torch.Generator`` (on the generator's device), and a
deterministic function applies those draws to the images. JAX draws from a
threefry key, which torch cannot reproduce; with the split a test feeds the
port the draws JAX made.

:func:`scale_and_translate` is ``jax.image.scale_and_translate`` with
``method="linear"`` and its default ``antialias=True``: per axis, a dense
(out, in) matrix of triangle-kernel weights, the kernel widened by
``1 / scale`` when it shrinks, each column normalized by its sum (JAX's
edge rule) and zeroed where the sample falls outside the input; applied
with one ``einsum`` per axis. Images come back as normalized float32 NCHW,
the model's layout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.model.preprocess import MEAN_RGB, STDDEV_RGB

_F32_EPS = float(torch.finfo(torch.float32).eps)


def _weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
                translation: torch.Tensor) -> torch.Tensor:
    """(M,) scales and translations -> (M, in_size, out_size) weights, JAX's
    ``compute_weight_mat`` with the triangle kernel and antialiasing."""
    dev = scale.device
    inv_scale = 1.0 / scale[:, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=scale.dtype, device=dev) + 0.5) * inv_scale
                - translation[:, None] * inv_scale - 0.5)  # (M, out)
    x = (torch.abs(sample_f[:, None, :]
                   - torch.arange(in_size, dtype=scale.dtype, device=dev)[None, :, None])
         / kernel_scale[:, :, None])
    weights = torch.clamp(1 - torch.abs(x), min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * _F32_EPS,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


def scale_and_translate(images: torch.Tensor, scale: torch.Tensor,
                        translation: torch.Tensor) -> torch.Tensor:
    """Resample each (S, S, C) image of ``images`` (M, S, S, C) float32 onto
    an output of the same size: ``scale`` and ``translation`` (M, 2) are
    (y, x) per image, as JAX's ``scale_and_translate(img, (S, S, C), (0, 1),
    scale, translation, method="linear")``."""
    s_y, s_x = images.shape[1], images.shape[2]
    wy = _weight_mat(s_y, s_y, scale[:, 0], translation[:, 0]).to(images.dtype)
    wx = _weight_mat(s_x, s_x, scale[:, 1], translation[:, 1]).to(images.dtype)
    out = torch.einsum("mhwc,mho->mowc", images, wy)
    return torch.einsum("mowc,mwp->mopc", out, wx)


class Draws(NamedTuple):
    """Every random choice of one augmented batch of B images of size S.

    ``use_m`` (B,) bool and ``perms`` (3, B) int64 partner indices (JAX's
    ``permutation(3B) % B``) and ``cy``/``cx`` (B,) mosaic centres, for the
    mosaic lane only; ``flip`` (B,) bool; ``scale`` (B,) (1 where the jitter
    was not drawn, i.e. ``do_jit`` false) and ``ty``/``tx`` (B,) the jitter's
    translations, ``u * (S - scale * S)``."""

    flip: torch.Tensor
    do_jit: torch.Tensor
    scale: torch.Tensor
    ty: torch.Tensor
    tx: torch.Tensor
    use_m: torch.Tensor | None = None
    perms: torch.Tensor | None = None
    cy: torch.Tensor | None = None
    cx: torch.Tensor | None = None


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _draw_flip_jitter(gen, b: int, s: int, lo: float, hi: float, jitter_p: float) -> dict:
    flip = _uniform(gen, (b,)) < 0.5
    do_jit = _uniform(gen, (b,)) < jitter_p
    scale = torch.where(do_jit, _uniform(gen, (b,), lo, hi), 1.0)
    span = s - scale * s  # positive when shrinking (pad), negative when zooming
    return {"flip": flip, "do_jit": do_jit, "scale": scale,
            "ty": _uniform(gen, (b,)) * span, "tx": _uniform(gen, (b,)) * span}


def draw(gen: torch.Generator, b: int, s: int, lo: float = 0.6, hi: float = 1.4) -> Draws:
    """The draws of :func:`augment_and_normalize`: flip (p = 0.5) and scale
    jitter (p = 0.5) in [lo, hi)."""
    return Draws(**_draw_flip_jitter(gen, b, s, lo, hi, 0.5))


def draw_mosaic(gen: torch.Generator, b: int, s: int, lo: float = 0.5, hi: float = 1.6,
                mosaic_p: float = 0.5, jitter_p: float = 0.5) -> Draws:
    """The draws of :func:`augment_mosaic_and_normalize`: mosaic (p =
    ``mosaic_p``, centres in [0.3 S, 0.7 S)), flip (p = 0.5), scale jitter
    (p = ``jitter_p``) in [lo, hi)."""
    perms = torch.randperm(3 * b, generator=gen, device=gen.device).reshape(3, b) % b
    centres = _uniform(gen, (b, 2), 0.3 * s, 0.7 * s)
    use_m = _uniform(gen, (b,)) < mosaic_p
    return Draws(**_draw_flip_jitter(gen, b, s, lo, hi, jitter_p), use_m=use_m, perms=perms,
                 cy=centres[:, 0], cx=centres[:, 1])


def _flip_jitter_normalize(images, boxes, valid, d: Draws):
    """Flip, scale jitter with crop or pad, box clip and drop, normalize;
    images (B, S, S, 3) float32 -> (B, 3, S, S)."""
    s = images.shape[1]
    images = torch.where(d.flip[:, None, None, None], images.flip(2), images)
    flipped = torch.stack([boxes[..., 0], s - boxes[..., 3], boxes[..., 2], s - boxes[..., 1]],
                          dim=-1)
    boxes = torch.where(d.flip[:, None, None], flipped, boxes)

    scale = d.scale.float()
    shift_yx = torch.stack([d.ty, d.tx], dim=-1).float()
    images = scale_and_translate(images, torch.stack([scale, scale], dim=-1), shift_yx)
    shift = torch.cat([shift_yx, shift_yx], dim=-1)[:, None, :]
    boxes = torch.clamp(boxes * scale[:, None, None] + shift, 0.0, s)
    valid = (valid & ((boxes[..., 2] - boxes[..., 0]) > 2.0)
             & ((boxes[..., 3] - boxes[..., 1]) > 2.0))
    images = (images - MEAN_RGB) / STDDEV_RGB
    return images.permute(0, 3, 1, 2), boxes.float(), valid


def augment_and_normalize(images_uint8: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                          draws: Draws):
    """Flip + scale jitter + normalize with ``draws`` (from :func:`draw`).

    images_uint8 (B, S, S, 3), boxes (B, G, 4) [ymin, xmin, ymax, xmax] in
    pixels, valid (B, G) bool -> (images (B, 3, S, S) float32 normalized,
    boxes, valid)."""
    return _flip_jitter_normalize(images_uint8.float(), boxes, valid, draws)


def _mosaic_batch(images, boxes, valid, d: Draws):
    """4-image mosaic collage: each image a 2x2 collage of itself and its
    three partners ``d.perms``, split at (``d.cy``, ``d.cx``); each partner
    resampled into its quadrant, its boxes moved with it.

    images (B, S, S, 3) float32 (not normalized), boxes (B, G, 4), valid
    (B, G) -> (images, boxes (B, 4G, 4), valid (B, 4G))."""
    b, s = images.shape[0], images.shape[1]
    g = boxes.shape[1]
    idx = torch.cat([torch.arange(b, device=images.device)[None], d.perms], dim=0).T  # (B, 4)
    img4, box4, val4 = images[idx], boxes[idx], valid[idx]
    cy, cx = d.cy.float(), d.cx.float()
    zero = torch.zeros_like(cy)
    # Quadrant geometry (B, 4): scale and offset along y and x.
    sy = torch.stack([cy / s, cy / s, (s - cy) / s, (s - cy) / s], dim=1)
    sx = torch.stack([cx / s, (s - cx) / s, cx / s, (s - cx) / s], dim=1)
    ty = torch.stack([zero, zero, cy, cy], dim=1)
    tx = torch.stack([zero, cx, zero, cx], dim=1)
    placed = scale_and_translate(
        img4.reshape(b * 4, s, s, 3), torch.stack([sy, sx], -1).reshape(b * 4, 2),
        torch.stack([ty, tx], -1).reshape(b * 4, 2)).reshape(b, 4, s, s, 3)
    pos = torch.arange(s, dtype=torch.float32, device=images.device)
    in_y = (pos >= ty[..., None]) & (pos < ty[..., None] + sy[..., None] * s)  # (B, 4, S)
    in_x = (pos >= tx[..., None]) & (pos < tx[..., None] + sx[..., None] * s)
    inside = in_y[:, :, :, None, None] & in_x[:, :, None, :, None]
    out = torch.where(inside, placed, 0.0).sum(dim=1)
    scale_vec = torch.stack([sy, sx, sy, sx], dim=-1)[:, :, None, :]
    shift_vec = torch.stack([ty, tx, ty, tx], dim=-1)[:, :, None, :]
    ob = (box4 * scale_vec + shift_vec).reshape(b, 4 * g, 4)
    ov = val4.reshape(b, 4 * g)
    ov = ov & ((ob[..., 2] - ob[..., 0]) > 2.0) & ((ob[..., 3] - ob[..., 1]) > 2.0)
    return out, ob, ov


def augment_mosaic_and_normalize(images_uint8: torch.Tensor, boxes: torch.Tensor,
                                 valid: torch.Tensor, draws: Draws):
    """Mosaic -> flip -> scale jitter -> normalize with ``draws`` (from
    :func:`draw_mosaic`). The GT capacity grows 4x: returns (images (B, 3,
    S, S) float32 normalized, boxes (B, 4G, 4), valid (B, 4G))."""
    g = boxes.shape[1]
    images = images_uint8.float()
    m_img, m_box, m_val = _mosaic_batch(images, boxes, valid, draws)
    # The plain lane padded to the mosaic's GT capacity.
    p_box = torch.nn.functional.pad(boxes, (0, 0, 0, 3 * g))
    p_val = torch.nn.functional.pad(valid, (0, 3 * g))
    use_m = draws.use_m
    images = torch.where(use_m[:, None, None, None], m_img, images)
    boxes = torch.where(use_m[:, None, None], m_box, p_box)
    valid = torch.where(use_m[:, None], m_val, p_val)
    return _flip_jitter_normalize(images, boxes, valid, draws)
