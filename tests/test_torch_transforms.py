"""The port's training-crop transforms (excel_tpu_torch.data.transforms)
against Pillow and against the JAX package's: `rescale` equal to Pillow's
BILINEAR image and NEAREST label resizes bit for bit over a seeded grid of
sizes and scales, and every random transform equal to
excel_tpu.data.transforms's on the same seeded generator (outputs and the
generator's state after it)."""
import numpy as np
import pytest
from PIL import Image

from excel_tpu.data import transforms as jt
from excel_tpu_torch.data import transforms as pt

# 240 cases: sizes from 1 px to 520 px (each side drawn on its own, so
# wide, tall and one-pixel images occur), scales over [0.5, 2.0] and the
# exact scales 0.5, 1.0 and 2.0
CASES = 240


def _cases():
    rng = np.random.default_rng(2024)
    out = []
    for i in range(CASES):
        if i % 8 == 0:
            h, w = (int(v) for v in rng.integers(1, 9, 2))
        else:
            h, w = (int(v) for v in rng.integers(1, 521, 2))
        scale = (0.5, 1.0, 2.0)[i % 3] if i % 10 == 9 else float(
            rng.uniform(0.5, 2.0))
        out.append((i, h, w, scale))
    return out


def _pil_rescale(image, scale, label):
    h, w = image.shape[:2]
    size = (int(scale * w), int(scale * h))
    img = np.asarray(Image.fromarray(image).resize(size,
                                                   Image.BILINEAR))
    lab = np.asarray(Image.fromarray(label).resize(size, Image.NEAREST))
    return img, lab


@pytest.mark.parametrize("chunk", range(4))
def test_rescale_equals_pillow_bit_for_bit(chunk):
    """RGB images of random bytes and of smooth gradients (where a wrong
    weight shows in every pixel), labels of random class ids; downscales
    and upscales. Where Pillow refuses an empty size, so does the port."""
    for i, h, w, scale in _cases()[chunk::4]:
        rng = np.random.default_rng(i)
        if i % 2:
            image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        else:
            yy, xx = np.mgrid[0:h, 0:w]
            image = np.stack([yy * 255 // max(h - 1, 1),
                              xx * 255 // max(w - 1, 1),
                              (yy + xx) % 256], axis=-1).astype(np.uint8)
        label = rng.integers(0, 21, (h, w), dtype=np.uint8)
        label[rng.random((h, w)) < 0.1] = 255
        try:
            ref = _pil_rescale(image, scale, label)
        except ValueError:
            with pytest.raises(ValueError):
                pt.rescale(image, scale, label)
            continue
        got = pt.rescale(image, scale, label)
        msg = f"case {i}: {h}x{w} x {scale}"
        for g, r in zip(got, ref):
            assert g.shape == r.shape and g.dtype == r.dtype, msg
            np.testing.assert_array_equal(g, r, err_msg=msg)
        np.testing.assert_array_equal(pt.rescale(image, scale), ref[0],
                                      err_msg=msg)


def test_rescale_of_a_greyscale_image_equals_pillow():
    rng = np.random.default_rng(5)
    image = rng.integers(0, 256, (37, 91), dtype=np.uint8)
    for size in ((45, 18), (182, 74), (91, 50), (3, 37)):
        ref = np.asarray(Image.fromarray(image).resize(size, Image.BILINEAR))
        np.testing.assert_array_equal(pt.resize_pil_bilinear(image, size),
                                      ref)


def _sample(seed: int, h: int = 90, w: int = 130):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    label = np.zeros((h, w), np.uint8)
    label[h // 4:h // 2, w // 3:] = 1 + seed % 20
    label[:5] = 255
    return image, label


def _same_generators(a: np.random.Generator, b: np.random.Generator):
    assert a.bit_generator.state == b.bit_generator.state


@pytest.mark.parametrize("seed", range(6))
def test_random_transforms_match_jax(seed):
    image, label = _sample(seed)
    for fn, args in ((pt.random_scaling, ((0.5, 2.0),)),
                     (pt.random_fliplr, ())):
        jfn = getattr(jt, fn.__name__)
        rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
        for kw in (dict(label=label), {}):
            ref = jfn(image, rj, *args, **kw)
            got = fn(image, rp, *args, **kw)
            for g, r in zip(got if kw else (got,), ref if kw else (ref,)):
                np.testing.assert_array_equal(g, r)
        _same_generators(rj, rp)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("crop", [64, 100, 200])
def test_random_crop_matches_jax(seed, crop):
    """Padding when the image is smaller than the crop, the window's
    cat-max-ratio retries (a label dominated by one class) and img_box."""
    image, label = _sample(seed)
    if seed % 2:
        label[:] = 3          # one class everywhere: all 10 draws
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    ref = jt.random_crop(image, rj, crop, label=label)
    got = pt.random_crop(image, rp, crop, label=label)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    ref = jt.random_crop(image, rj, crop)
    got = pt.random_crop(image, rp, crop)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    _same_generators(rj, rp)


@pytest.mark.parametrize("seed", range(8))
def test_photometric_distortion_matches_jax(seed):
    image, _ = _sample(seed, 40, 50)
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        np.testing.assert_array_equal(pt.photometric_distortion(image, rp),
                                      jt.photometric_distortion(image, rj))
    _same_generators(rj, rp)
    hsv = jt._rgb_to_hsv(image.astype(np.float32))
    np.testing.assert_array_equal(pt._rgb_to_hsv(image.astype(np.float32)),
                                  hsv)
    np.testing.assert_array_equal(pt._hsv_to_rgb(hsv), jt._hsv_to_rgb(hsv))
