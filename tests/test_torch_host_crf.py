"""The port's host dense CRF (excel_tpu_torch.crf, its own copy of the
lattice source built into excel_tpu_torch/_build/) against the JAX
package's (excel_tpu.crf): the same source through the same g++ and flags,
so equal bit for bit; and the port's crf_scene against the JAX package's.
Scenes at 96 x 128 with 21 classes."""
import os

import numpy as np
import pytest

from excel_tpu import crf as jcrf
from excel_tpu.data.synthetic import crf_scene as jax_crf_scene
from excel_tpu_torch import build
from excel_tpu_torch import crf as pcrf
from excel_tpu_torch.data.synthetic import crf_scene

HW = (96, 128)
KINDS = ("blobs", "thin", "texture")
# the reference's parameter sets: the class's defaults, the eval protocol
# (tools/infer_seg_voc.py:113-120) and the MSC dev script's
# (tools/test_msc_flip_voc.py:144-151), as tools/exp_crf_agreement.py names
# them
PARAMS = {
    "default": {},
    "voc": dict(iter_max=10, pos_w=3.0, pos_xy_std=1.0, bi_w=4.0,
                bi_xy_std=67.0, bi_rgb_std=3.0),
    "msc_dev": dict(iter_max=10, pos_w=3.0, pos_xy_std=3.0, bi_w=4.0,
                    bi_xy_std=64.0, bi_rgb_std=5.0),
}


@pytest.mark.parametrize("kind", KINDS)
def test_crf_scene_equals_jax(kind):
    for seed in (0, 1):
        for got, ref in zip(crf_scene(kind, seed=seed, hw=HW),
                            jax_crf_scene(kind, seed=seed, hw=HW)):
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        crf_scene("stripes")


@pytest.mark.parametrize("pset", sorted(PARAMS))
@pytest.mark.parametrize("kind", KINDS)
def test_dense_crf_equals_jax_bit_for_bit(kind, pset):
    image, _, probs = crf_scene(kind, seed=0, hw=HW)
    got = pcrf.DenseCRF(**PARAMS[pset])(image, probs)
    ref = jcrf.DenseCRF(**PARAMS[pset])(image, probs)
    assert got.dtype == np.float32 and got.shape == probs.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got.sum(0), 1.0, atol=1e-5)


def test_fixed_parameter_sets_equal_jax():
    image, gt, probs = crf_scene("blobs", seed=2, hw=HW)
    np.testing.assert_array_equal(pcrf.crf_inference(image, probs, t=5),
                                  jcrf.crf_inference(image, probs, t=5))
    got = pcrf.crf_inference_label(image, gt, t=5, n_labels=21)
    np.testing.assert_array_equal(
        got, jcrf.crf_inference_label(image, gt, t=5, n_labels=21))
    assert got.shape == gt.shape


def test_crf_batch_same_for_any_thread_count():
    items = [crf_scene(kind, seed=3, hw=HW)[::2] for kind in KINDS]
    crf = pcrf.DenseCRF(**PARAMS["voc"])
    one = pcrf.crf_batch(items, crf, num_threads=1)
    three = pcrf.crf_batch(items, crf, num_threads=3)
    assert len(one) == len(three) == len(items)
    for a, b, (image, probs) in zip(one, three, items):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, crf(image, probs))


def test_dense_crf_refuses_mismatched_image():
    image, _, probs = crf_scene("blobs", seed=0, hw=HW)
    with pytest.raises(ValueError, match="DenseCRF"):
        pcrf.DenseCRF()(image[:-1], probs)


def test_library_is_built_under_build_dir_not_beside_the_source():
    pcrf._load()
    path = build.host_library_path()
    assert os.path.dirname(path) == build.BUILD_DIR
    assert os.path.basename(path).startswith("libexcelcrf-")
    assert os.path.exists(path)
    assert sorted(os.listdir(build.NATIVE)) == ["densecrf.cpp", "jpeg.cpp"]
    assert build.build_host() == 0.0            # built: nothing to do


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "GXX", "false")
    with pytest.raises(RuntimeError, match="failed to build"):
        build.build_host()
    assert os.listdir(tmp_path) == []           # no half-written library
