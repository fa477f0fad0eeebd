"""Port label utilities (excel_tpu_torch.ops.labels) against the JAX
package's, including the zeros that scale_and_translate writes beyond each
image's valid extent."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from excel_tpu.ops import labels as jlab
from excel_tpu_torch.ops import labels as plab
from torch_port_common import n, t

# one-step bilinear weights renormalised in another order: 1e-6 abs on
# values in [0, 1]
ATOL = 1e-6


def test_upscale_writes_zero_beyond_extent():
    """1x4 -> a 1x12 canvas at scale 1.5: edge taps renormalise inside the
    extent, and everything beyond it is 0 (not an edge continuation)."""
    x = np.asarray([1, 2, 3, 4], np.float32).reshape(1, 1, 1, 4)
    valid = np.asarray([[1, 6]], np.int32)
    got = n(plab.upscale_to_canvas(t(x), t(valid), (1, 12)))[0, 0, 0]
    ref = np.asarray(jlab.upscale_to_canvas(jnp.asarray(x),
                                            jnp.asarray(valid), (1, 12)))
    np.testing.assert_allclose(got, ref[0, 0, 0], atol=ATOL)
    np.testing.assert_allclose(
        got, [1, 1.5, 2.1666667, 2.8333333, 3.5, 4, 0, 0, 0, 0, 0, 0],
        atol=1e-6)


def test_upscale_to_canvas_both_conventions_match():
    rng = np.random.default_rng(0)
    x = rng.random((3, 4, 20, 20), dtype=np.float32)
    valid = np.asarray([[375, 500], [333, 500], [200, 150]], np.int32)
    # half-pixel sampling ends at the extent; the align_corners mapping
    # still reaches the last input row up to half a scale step beyond it
    for port_fn, jax_fn, margin in (
            (plab.upscale_to_canvas, jlab.upscale_to_canvas, 0),
            (plab.upscale_to_canvas_align, jlab.upscale_to_canvas_align, 6)):
        got = n(port_fn(t(x), t(valid), (384, 512)))
        ref = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(valid),
                                (384, 512)))
        np.testing.assert_allclose(got, ref, atol=ATOL)
        assert not got[2, :, 200 + margin:].any()
        assert not got[2, :, :, 150 + margin:].any()
        assert got[2, :, 199, :150].all() and got[2, :, :200, 149].all()


def test_cams_with_background_canvas_matches():
    rng = np.random.default_rng(1)
    refined = rng.random((2, 3, 5, 5), dtype=np.float32)
    cls = np.asarray([[1, 0, 1], [0, 1, 0]], np.float32)
    valid = np.asarray([[60, 80], [64, 50]], np.int32)
    got = plab.cams_with_background_canvas(t(refined), t(cls), t(valid),
                                           (64, 128))
    ref = jlab.cams_with_background_canvas(
        jnp.asarray(refined), jnp.asarray(cls), jnp.asarray(valid),
        (64, 128))
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=ATOL)


def test_slots_and_argmax_exact():
    rng = np.random.default_rng(2)
    cls = np.zeros((4, 20), np.float32)
    for i, k in enumerate((1, 2, 3, 0)):
        cls[i, rng.choice(20, size=k, replace=False)] = 1
    for slots in (2, 3):
        pidx, pmask = plab.class_slot_index(t(cls), slots)
        jidx, jmask = jlab.class_slot_index(jnp.asarray(cls), slots)
        np.testing.assert_array_equal(n(pidx), np.asarray(jidx))
        np.testing.assert_array_equal(n(pmask), np.asarray(jmask))
        cams = rng.random((4, 1 + slots, 8, 8), dtype=np.float32)
        cams[0, 1] = cams[0, 0]                  # a tie: first index wins
        pl = plab.argmax_label(t(cams), pmask)
        jl = jlab.argmax_label(jnp.asarray(cams), jmask)
        np.testing.assert_array_equal(n(pl), np.asarray(jl))
        np.testing.assert_array_equal(
            n(plab.slot_label_to_class(pl, pidx)),
            np.asarray(jlab.slot_label_to_class(jl, jidx)))


# ---------------------------------------------------------------------------
# the training path's label utilities
# ---------------------------------------------------------------------------

def test_upsample_linear_equals_jax_resize_with_gradient():
    """jax.image.resize(linear) upsampling by an integer factor equals
    F.interpolate(bilinear, align_corners=False): the same two taps with
    the same weights, the edge held beyond the outer sample centres. Values
    1e-6 abs; the gradient of a weighted sum (each entry a sum of ~256
    products of size ~1, in another order) 1e-5 abs and relative. Factors
    that do not divide raise (jax antialiases when it downsamples)."""
    import jax
    import pytest

    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    w = rng.standard_normal((2, 3, 64, 80)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 3, 64, 80), method="linear")
    ref_grad = jax.grad(lambda a: (jax.image.resize(
        a, (2, 3, 64, 80), method="linear") * w).sum())(jnp.asarray(x))
    xt = t(x).requires_grad_()
    got = plab.upsample_linear(xt, (64, 80))
    (got * t(w)).sum().backward()
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(n(xt.grad), np.asarray(ref_grad), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError):
        plab.upsample_linear(xt, (6, 7))


def test_cams_with_background_matches():
    rng = np.random.default_rng(12)
    refined = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    cls = np.asarray([[1, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    ref = jlab.cams_with_background(jnp.asarray(refined), jnp.asarray(cls),
                                    (64, 64))
    got = plab.cams_with_background(t(refined), t(cls), (64, 64))
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=ATOL)


def test_radius_mask_and_affinity_label_exact():
    """The Chebyshev radius mask, and the affinity targets from labels
    nearest-downsampled at rows and columns 0, 16, 32, ... (ignore where
    the mask is 0 or either cell is ignored)."""
    for h, w, r in ((4, 4, 2), (20, 20, 5), (3, 5, 1)):
        np.testing.assert_array_equal(plab.radius_mask(h, w, r),
                                      jlab.radius_mask(h, w, r))
    rng = np.random.default_rng(13)
    label = rng.integers(0, 4, (2, 64, 64)).astype(np.int32)
    label[rng.random((2, 64, 64)) < 0.3] = 255
    mask = jlab.radius_mask(4, 4, 2)
    for m in (None, mask):
        ref = jlab.affinity_label(jnp.asarray(label),
                                  None if m is None else jnp.asarray(m))
        got = plab.affinity_label(t(label), None if m is None else t(m))
        np.testing.assert_array_equal(n(got), np.asarray(ref))


# ---------------------------------------------------------------------------
# lam_to_label, boxes_to_masks, argmax_label's box mask
# ---------------------------------------------------------------------------

def _boxes(rng, b, h, w):
    y0 = rng.integers(0, h // 2, b)
    x0 = rng.integers(0, w // 2, b)
    return np.stack([y0, rng.integers(h // 2, h + 1, b), x0,
                     rng.integers(w // 2, w + 1, b)], axis=1).astype(np.int32)


def test_boxes_to_masks_exact():
    boxes = _boxes(np.random.default_rng(7), 3, 12, 16)
    np.testing.assert_array_equal(
        n(plab.boxes_to_masks(t(boxes), 12, 16)),
        np.asarray(jlab.boxes_to_masks(jnp.asarray(boxes), 12, 16)))


@pytest.mark.parametrize("ignore_mid", [False, True])
@pytest.mark.parametrize("boxed", [False, True])
def test_lam_to_label_exact(ignore_mid, boxed):
    rng = np.random.default_rng(8)
    cam = rng.random((3, 5, 12, 16), dtype=np.float32)
    cam[0, 2] = cam[0, 1]                      # a tie: first index wins
    cls = (rng.random((3, 5)) < 0.5).astype(np.float32)
    cls[2] = 0                                 # no class: all background
    box = _boxes(rng, 3, 12, 16) if boxed else None
    pbox = plab.boxes_to_masks(t(box), 12, 16) if boxed else None
    jbox = jlab.boxes_to_masks(jnp.asarray(box), 12, 16) if boxed else None
    pv, pl = plab.lam_to_label(t(cam), t(cls), ignore_mid=ignore_mid,
                               ignore_index=254, box_mask=pbox)
    jv, jl = jlab.lam_to_label(jnp.asarray(cam), jnp.asarray(cls),
                               ignore_mid=ignore_mid, ignore_index=254,
                               box_mask=jbox)
    np.testing.assert_array_equal(n(pv), np.asarray(jv))
    np.testing.assert_array_equal(n(pl), np.asarray(jl))
    assert pl.dtype == torch.int32
    assert (n(pl) == 254).any() == (ignore_mid or boxed)


def test_argmax_label_box_mask_exact():
    rng = np.random.default_rng(9)
    cams = rng.random((2, 4, 10, 12), dtype=np.float32)
    cls = np.asarray([[1, 0, 1], [0, 1, 0]], np.float32)
    box = _boxes(rng, 2, 10, 12)
    for ignore_index in (255, 77):
        pl = plab.argmax_label(t(cams), t(cls),
                               box_mask=plab.boxes_to_masks(t(box), 10, 12),
                               ignore_index=ignore_index)
        jl = jlab.argmax_label(jnp.asarray(cams), jnp.asarray(cls),
                               box_mask=jlab.boxes_to_masks(
                                   jnp.asarray(box), 10, 12),
                               ignore_index=ignore_index)
        np.testing.assert_array_equal(n(pl), np.asarray(jl))
        assert (n(pl) == ignore_index).any()
