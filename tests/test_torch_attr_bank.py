"""The port's attribute-bank tool (excel_tpu_torch/cli/make_attr_bank.py)
and its KMeans (excel_tpu_torch/utils/kmeans.py) against
excel_tpu/cli/make_attr_bank.py and the scikit-learn KMeans it calls.

KMeans: labels and iteration counts equal to sklearn's, centres within
1e-5, inertia within 1e-5 relative (sklearn sums its centre updates across
OpenMP threads in the order they finish). The tool: both packages' CLIs
run `--tiny --device cpu` from one `--clip-params` npz written by the JAX
package's `save_params_npz`; equal class flags, banks within 1e-5, the same
descriptor JSON."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans

from excel_tpu.cli import make_attr_bank as jbank
from excel_tpu.config import tiny_config as jax_tiny_config
from excel_tpu.models.params import save_params_npz
from excel_tpu_torch.cli import make_attr_bank as pbank
from excel_tpu_torch.config import tiny_config
from excel_tpu_torch.models.clip import text_forward
from excel_tpu_torch.text.tokenizer import tokenize
from excel_tpu_torch.utils.kmeans import kmeans

from torch_port_common import jax_clip_tree, port_params

CENTRE_TOL = 1e-5
INERTIA_RTOL = 1e-5


def _blobs(seed: int, n: int, d: int, c: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 2, (c, d))
    x = centres[rng.integers(0, c, n)] + rng.normal(0, 0.3, (n, d))
    return x.astype(np.float32)


def _unit(seed: int, n: int, d: int) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _text_cfg(cfg):
    """The tiny config with the real tokenizer's context length and
    vocabulary: `tokenize` frames 77 ids from a 49,408-word vocabulary, which
    the tiny config's 16-position, 512-row tables cannot take (in either
    package)."""
    return dataclasses.replace(cfg, clip=dataclasses.replace(
        cfg.clip, context_length=77, vocab_size=49408))


@pytest.fixture(scope="module")
def text_embeddings():
    """The tiny text tower's unit embeddings of VOC's 400 descriptor
    sentences."""
    cfg = _text_cfg(tiny_config())
    params = port_params(jax_clip_tree(_text_cfg(jax_tiny_config()).clip),
                         cfg.clip)
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "assets", "attributes",
            "pascal_voc_descriptors.json")) as f:
        sentences = [s.lower() for v in json.load(f).values() for s in v]
    with torch.no_grad():
        emb = text_forward(params, torch.from_numpy(tokenize(sentences)),
                           cfg.clip).numpy()
    return emb / np.linalg.norm(emb, axis=-1, keepdims=True)


CASES = {
    "blobs": (lambda: _blobs(0, 600, 16, 12), 20),
    "blobs_many_chunks": (lambda: _blobs(1, 1600, 32, 40), 224),
    "blobs_float64": (lambda: _blobs(2, 300, 8, 5).astype(np.float64), 7),
    "unit_512d": (lambda: _unit(3, 400, 512), 112),
    "few_samples": (lambda: _unit(4, 40, 24), 30),
}


@pytest.mark.parametrize("case", sorted(CASES) + ["tiny_text_tower_12",
                                                  "tiny_text_tower_112"])
def test_kmeans_matches_sklearn(case, text_embeddings):
    if case.startswith("tiny_text_tower"):
        x, k = text_embeddings, int(case.rsplit("_", 1)[1])
    else:
        make, k = CASES[case]
        x = make()
    ref = KMeans(n_clusters=k, random_state=0).fit(x)
    got = kmeans(x, k, seed=0)
    assert got.cluster_centers_.dtype == ref.cluster_centers_.dtype
    assert got.cluster_centers_.shape == (k, x.shape[1])
    np.testing.assert_array_equal(got.labels_, ref.labels_)
    assert got.n_iter_ == ref.n_iter_
    np.testing.assert_allclose(got.cluster_centers_, ref.cluster_centers_,
                               rtol=0, atol=CENTRE_TOL)
    assert abs(got.inertia_ - ref.inertia_) <= INERTIA_RTOL * ref.inertia_


def test_kmeans_relocates_empty_clusters_as_sklearn():
    """Duplicated points leave k-means++ fewer distinct candidates than
    clusters, and empty clusters go to the farthest points."""
    base = _blobs(5, 24, 4, 3)
    x = np.concatenate([base] * 5)
    for k in (20, 23):
        ref = KMeans(n_clusters=k, random_state=0).fit(x)
        got = kmeans(x, k, seed=0)
        np.testing.assert_array_equal(got.labels_, ref.labels_)
        assert got.n_iter_ == ref.n_iter_
        np.testing.assert_allclose(got.cluster_centers_,
                                   ref.cluster_centers_, atol=CENTRE_TOL)
    with pytest.raises(ValueError, match="n_clusters"):
        kmeans(base, 25)


def test_kmeans_stops_on_the_tolerance_as_sklearn():
    """Uniform 2-d points whose labels still move when the summed squared
    centre shift falls below the tolerance: the stop, and the E-step after
    it, as sklearn's."""
    x = np.random.default_rng(1).uniform(size=(3000, 2)).astype(np.float32)
    ref = KMeans(n_clusters=40, random_state=0).fit(x)
    got = kmeans(x, 40, seed=0)
    assert kmeans(x, 40, seed=0, tol=1e-12).n_iter_ > got.n_iter_
    np.testing.assert_array_equal(got.labels_, ref.labels_)
    assert got.n_iter_ == ref.n_iter_
    np.testing.assert_allclose(got.cluster_centers_, ref.cluster_centers_,
                               rtol=0, atol=CENTRE_TOL)


def _txt_dump(path, names, entries=20):
    lines = []
    for c in names:
        lines += [f"{c}:\n", "[\n"]
        lines += [f'  "has a {c}-like part number {i}",\n'
                  for i in range(entries)]
        lines += ["]\n", "\n"]
    with open(path, "w") as f:
        f.writelines(lines)


def test_descriptors_from_txt_matches_jax(tmp_path):
    names = ["aeroplane", "bicycle", "bird"]
    path = str(tmp_path / "dump.txt")
    _txt_dump(path, names)
    for kw in ({}, {"prompt": "a photo of a {}: ", "entries_per_cls": 7}):
        got = pbank.descriptors_from_txt(path, names, **kw)
        assert got == jbank.descriptors_from_txt(path, names, **kw)
    got = pbank.descriptors_from_txt(path, names)
    assert got["bird"][0] == ("a clean origami bird. has a bird-like part "
                              "number 0")


@pytest.fixture(scope="module")
def clip_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bank") / "clip.npz")
    save_params_npz(path, jax.device_get(jax_clip_tree(
        _text_cfg(jax_tiny_config()).clip)))
    return path


@pytest.fixture
def text_tiny(monkeypatch):
    """`--tiny` resolves to `_text_cfg(tiny_config())` in both CLIs."""
    from excel_tpu.cli import common as jcommon
    from excel_tpu_torch.cli import common as pcommon

    for mod in (jcommon, pcommon):
        monkeypatch.setattr(mod, "tiny_config",
                            lambda real=mod.tiny_config: _text_cfg(real()))


@pytest.mark.parametrize("run", ["voc", "coco", "voc_from_txt"])
def test_make_attr_bank_matches_jax(run, clip_npz, text_tiny, tmp_path,
                                    capsys):
    from excel_tpu.text.class_names import class_list

    dataset = run.split("_")[0]
    flags = ["--tiny", "--dataset", dataset, "--clip-params", clip_npz]
    if run.endswith("from_txt"):
        txt = str(tmp_path / "dump.txt")
        _txt_dump(txt, class_list("pascal_voc")[1:])
        flags += ["--from-txt", txt]
    out_j, out_p = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jbank.main(flags + ["--out", out_j])
    jax_log = capsys.readouterr().out
    pbank.main(flags + ["--device", "cpu", "--out", out_p])
    port_log = capsys.readouterr().out
    with np.load(out_j) as a, np.load(out_p) as b:
        assert sorted(a.files) == sorted(b.files) == ["class_flags",
                                                      "cluster_bank"]
        assert b["cluster_bank"].dtype == b["class_flags"].dtype == np.float32
        n_cls = 20 if dataset == "voc" else 80
        k = tiny_config().num_attr_clusters
        assert b["cluster_bank"].shape == (tiny_config().clip.embed_dim, k)
        np.testing.assert_array_equal(b["class_flags"], a["class_flags"])
        assert b["class_flags"].shape == (n_cls, k)
        assert (b["class_flags"].sum(axis=1) >= 1).all()
        np.testing.assert_allclose(b["cluster_bank"], a["cluster_bank"],
                                   rtol=0, atol=CENTRE_TOL)
    json_j, json_p = (o.rsplit(".", 1)[0] + "_descriptors.json"
                      for o in (out_j, out_p))
    assert port_log == jax_log.replace(json_j, json_p).replace(out_j, out_p)
    if run.endswith("from_txt"):
        with open(json_j) as f:
            ref = f.read()
        with open(json_p) as f:
            assert f.read() == ref


def test_make_attr_bank_default_device_needs_a_gpu(clip_npz, text_tiny,
                                                   tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbank.main(["--tiny", "--clip-params", clip_npz,
                    "--out", str(tmp_path / "b.npz")])
