"""The port's crop_flip augmentation (kubeflow_tpu_torch/training/
augment.py) on the CPU: its resample against
`jax.image.scale_and_translate(method="linear", antialias=False)` on a
table of fixed crop boxes and flips (f32, within 1e-5: the two
contractions' summation order), the JAX package's `test_augment.py`
properties in the port, and the crop distribution against the JAX
package's (threefry and numpy's streams differ, so the two are held by
two-sample Kolmogorov-Smirnov tests at p > 0.001, not value by value)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from kubeflow_tpu_torch.training.augment import (  # noqa: E402
    augment_image_batch,
    crop_boxes,
    crop_params,
    random_resized_crop_flip,
    resample,
)

ATOL = 1e-5


def images(b=8, h=16, w=16, c=3, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, h, w, c), dtype=np.float32))


# (crop_h, crop_w, off_y, off_x, flip) on a 16 x 12 image
BOXES = [(16.0, 12.0, 0.0, 0.0, False), (16.0, 12.0, 0.0, 0.0, True),
         (8.0, 6.0, 4.0, 3.0, False), (5.5, 9.25, 10.5, 2.75, True),
         (1.0, 1.0, 15.0, 11.0, False), (3.3, 12.0, 0.2, 0.0, True),
         (12.7, 4.1, 3.3, 7.9, False)]


@pytest.mark.parametrize("box", BOXES, ids=[str(b) for b in BOXES])
def test_resample_equals_scale_and_translate(box):
    x = images(b=1, h=16, w=12)
    ch, cw, oy, ox, flip = box
    sy, sx = 16 / ch, 12 / cw
    want = jax.image.scale_and_translate(
        jnp.asarray(x[0].numpy()), (16, 12, 3), (0, 1),
        jnp.array([sy, sx], jnp.float32),
        jnp.array([-oy * sy, -ox * sx], jnp.float32),
        method="linear", antialias=False)
    want = np.asarray(want)[:, ::-1] if flip else np.asarray(want)
    t = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    got = resample(x, t(ch), t(cw), t(oy), t(ox), torch.tensor([flip]))
    np.testing.assert_allclose(got[0].numpy(), want, atol=ATOL, rtol=0)


def test_shape_and_dtype_preserved():
    x = images()
    y = random_resized_crop_flip(x, seed=0, step=1)
    assert y.shape == x.shape and y.dtype == x.dtype
    y16 = random_resized_crop_flip(x.bfloat16(), seed=0, step=1)
    assert y16.dtype == torch.bfloat16


def test_deterministic_in_seed_and_step():
    x = images()
    a = random_resized_crop_flip(x, seed=7, step=3)
    b = random_resized_crop_flip(x, seed=7, step=3)
    assert torch.equal(a, b)
    assert not torch.allclose(a, random_resized_crop_flip(x, seed=7, step=4))
    assert not torch.allclose(a, random_resized_crop_flip(x, seed=8, step=3))


def test_identity_when_crop_disabled():
    x = images()
    y = random_resized_crop_flip(x, 3, 0, scale=(1.0, 1.0), ratio=(1.0, 1.0),
                                 flip_prob=0.0)
    np.testing.assert_allclose(y.numpy(), x.numpy(), atol=ATOL)


def test_pure_flip_produces_mirrored_or_identical_images():
    x = images(b=64)
    y = random_resized_crop_flip(x, 5, 0, scale=(1.0, 1.0),
                                 ratio=(1.0, 1.0)).numpy()
    xn = x.numpy()
    kinds = []
    for i in range(64):
        if np.allclose(y[i], xn[i], atol=ATOL):
            kinds.append("id")
        elif np.allclose(y[i], xn[i, :, ::-1], atol=ATOL):
            kinds.append("flip")
        else:
            kinds.append("other")
    assert "other" not in kinds
    assert 10 < kinds.count("flip") < 54  # ~Binomial(64, 0.5)


def test_per_image_independence():
    """Image i's crop is row i of the (seed, step) draw: the first images
    of a 2-batch and of an 8-batch match, whatever their neighbours."""
    x = images(b=8)
    small = random_resized_crop_flip(x[:2], 9, 2)
    big = random_resized_crop_flip(torch.cat([x[:2], images(b=6, seed=1)]),
                                   9, 2)
    np.testing.assert_allclose(small.numpy(), big[:2].numpy(), atol=1e-6)


def test_crops_stay_in_range():
    x = images(b=16).clamp(-1.0, 1.0)
    y = random_resized_crop_flip(x, 11, 0)
    assert y.min() >= -1.0 - 1e-4 and y.max() <= 1.0 + 1e-4
    ch, cw, oy, ox, _ = crop_boxes(torch.from_numpy(crop_params(11, 0, 512)),
                                   16, 12)
    assert (ch >= 1).all() and (ch <= 16).all() and (cw >= 1).all()
    assert (cw <= 12).all() and (oy >= 0).all() and (ox >= 0).all()
    assert (oy + ch <= 16 + 1e-4).all() and (ox + cw <= 12 + 1e-4).all()


def test_augment_image_batch_dispatch():
    x = images()
    batch = {"image": x, "label": torch.zeros(8, dtype=torch.long)}
    assert augment_image_batch(batch, "none", 0, 0)["image"] is x
    out = augment_image_batch(batch, "crop_flip", 0, 0)
    assert out["image"].shape == x.shape and out["label"] is batch["label"]
    with pytest.raises(ValueError):
        augment_image_batch(batch, "cutmix", 0, 0)


def test_crop_distribution_equals_the_jax_recipe():
    """Areas, log-ratios, offsets and flips of 4096 crops against the JAX
    package's draws of the same recipe (its per-image key splits)."""
    n, h, w = 4096, 224, 224
    ch, cw, oy, ox, flip = (t.numpy() for t in crop_boxes(
        torch.from_numpy(crop_params(0, 0, n)), h, w))

    def one(key):
        k_area, k_ratio, k_y, k_x, k_flip = jax.random.split(key, 5)
        area = jax.random.uniform(k_area, minval=0.08, maxval=1.0) * h * w
        lr = jax.random.uniform(k_ratio, minval=jnp.log(jnp.float32(3 / 4)),
                                maxval=jnp.log(jnp.float32(4 / 3)))
        r = jnp.exp(lr)
        c_h = jnp.clip(jnp.sqrt(area / r), 1.0, h)
        c_w = jnp.clip(jnp.sqrt(area * r), 1.0, w)
        return (c_h, c_w, jax.random.uniform(k_y) * (h - c_h),
                jax.random.uniform(k_x) * (w - c_w),
                jax.random.bernoulli(k_flip, 0.5))

    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.PRNGKey(0), jnp.arange(n, dtype=jnp.uint32))
    jh, jw, jy, jx, jflip = (np.asarray(v) for v in jax.vmap(one)(keys))
    for got, want in ((ch * cw, jh * jw), (np.log(cw / ch), np.log(jw / jh)),
                      (oy, jy), (ox, jx)):
        assert stats.ks_2samp(got, want).pvalue > 1e-3
    assert abs(flip.mean() - jflip.mean()) < 0.05
