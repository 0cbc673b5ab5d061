"""Training augmentation on the device: random-resized-crop + horizontal
flip (port of kubeflow_tpu/training/augment.py).

The recipe is the JAX package's: crop area uniform in [0.08, 1] of the
image, log aspect ratio uniform in [log 3/4, log 4/3], the crop's sides
clipped to [1, size], offsets uniform, resized back to the image's size
by linear resampling without antialias, then a 50 % horizontal flip.
Labels are untouched. Eval stays un-augmented.

- The five scalars of image i come from numpy's stream
  `default_rng([seed, step, AUGMENT_SALT])`, row i of a [B, 5] draw: a
  pure function of (seed, step, i). A resumed run replays the crops, and
  an image's crop does not depend on its neighbours or on the batch size.
  (The JAX package keys jax.random by fold_in(step key, i); threefry's
  stream cannot be reproduced here, so the two draw different crops from
  the same distribution.)
- The resample runs on the images' device as two batched contractions
  with separable weight matrices [B, H_out, H_in] and [B, W_out, W_in],
  which is what `jax.image.scale_and_translate(method="linear",
  antialias=False)` computes (`compute_weight_mat` of
  jax/_src/image/scale.py: sample centres (j + 0.5 - t)/s - 0.5, a
  triangle kernel, weights normalised by their sum, zero weight for a
  sample outside the image). The flip reverses the output columns of
  the W matrix, so it costs nothing.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

# the third word of the augment stream's numpy seed: keeps it apart from
# every other (seed, step) stream of the trainer
AUGMENT_SALT = 0xA06
SCALE = (0.08, 1.0)
RATIO = (3.0 / 4.0, 4.0 / 3.0)
FLIP_PROB = 0.5


def crop_params(seed: int, step: int, batch: int) -> np.ndarray:
    """[B, 5] f32 uniforms in [0, 1) (area, log-ratio, y offset, x
    offset, flip) of images 0..B-1 at (seed, step)."""
    rng = np.random.default_rng([int(seed), int(step), AUGMENT_SALT])
    return rng.random((batch, 5), dtype=np.float32)


def weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
               translation: torch.Tensor) -> torch.Tensor:
    """[B, out, in] linear-resampling weights of `scale_and_translate`
    (antialias off) for per-image `scale` and `translation` [B]."""
    dt, dev = scale.dtype, scale.device
    inv = (1.0 / scale)[:, None]
    sample = ((torch.arange(out_size, dtype=dt, device=dev) + 0.5) * inv
              - translation[:, None] * inv - 0.5)            # [B, out]
    x = (sample[:, :, None]
         - torch.arange(in_size, dtype=dt, device=dev)).abs()  # [B, out, in]
    w = (1.0 - x).clamp_min(0.0)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, :, None], w, torch.zeros_like(w))


def crop_boxes(u: torch.Tensor, h: int, w: int,
               scale: Tuple[float, float] = SCALE,
               ratio: Tuple[float, float] = RATIO,
               flip_prob: float = FLIP_PROB):
    """The crop boxes of uniforms u [B, 5]: (crop_h, crop_w, off_y, off_x,
    flip) each [B]."""
    area = (scale[0] + (scale[1] - scale[0]) * u[:, 0]) * h * w
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    r = torch.exp(lo + (hi - lo) * u[:, 1])
    crop_h = torch.sqrt(area / r).clamp(1.0, h)
    crop_w = torch.sqrt(area * r).clamp(1.0, w)
    off_y = u[:, 2] * (h - crop_h)
    off_x = u[:, 3] * (w - crop_w)
    return crop_h, crop_w, off_y, off_x, u[:, 4] < flip_prob


def resample(images: torch.Tensor, crop_h, crop_w, off_y, off_x, flip
             ) -> torch.Tensor:
    """Each image [B, H, W, C] cropped to its box, resized back to H x W
    (linear) and, where `flip`, mirrored along W; in the images' dtype."""
    b, h, w, c = images.shape
    sy, sx = h / crop_h, w / crop_w
    wy = weight_mat(h, h, sy, -off_y * sy)            # [B, H_out, H_in]
    wx = weight_mat(w, w, sx, -off_x * sx)            # [B, W_out, W_in]
    wx = torch.where(flip[:, None, None], wx.flip(1), wx)
    x = images.float()
    out = torch.einsum("boh,bhwc->bowc", wy, x)
    out = torch.einsum("bpw,bowc->bopc", wx, out)
    return out.to(images.dtype)


def random_resized_crop_flip(images: torch.Tensor, seed: int, step: int,
                             scale: Tuple[float, float] = SCALE,
                             ratio: Tuple[float, float] = RATIO,
                             flip_prob: float = FLIP_PROB,
                             rows: Optional[np.ndarray] = None
                             ) -> torch.Tensor:
    """Batched random-resized-crop + flip of [B, H, W, C] images at
    (seed, step), on the images' device. `rows` are the images' indices
    in the step's global batch (a data-parallel rank's share; default
    0..B-1): image i crops as row rows[i] of the global batch would."""
    b, h, w, _ = images.shape
    if rows is None:
        u = crop_params(seed, step, b)
    else:
        u = crop_params(seed, step, int(rows.max()) + 1)[rows]
    u = torch.from_numpy(np.ascontiguousarray(u))
    if images.device.type == "cuda":
        u = u.pin_memory().to(images.device, non_blocking=True)
    return resample(images, *crop_boxes(u, h, w, scale, ratio, flip_prob))


def augment_image_batch(batch: dict, kind: str, seed: int, step: int,
                        rows: Optional[np.ndarray] = None) -> dict:
    """The configured augmentation of an {image, label} batch: "none"
    passes it through, "crop_flip" is the recipe above (`rows`: the
    images' global indices)."""
    if kind == "none" or "image" not in batch:
        return batch
    if kind != "crop_flip":
        raise ValueError(f"unknown augmentation {kind!r}")
    out = dict(batch)
    out["image"] = random_resized_crop_flip(batch["image"], seed, step,
                                            rows=rows)
    return out
