"""The port's label-file tool (excel_tpu_torch.cli.make_cls_labels) against
tools/make_cls_labels.py on the same trees: VOC-layout synthetic trees
(two seeds, two splits in one run, --num-fg given and defaulted) and a
COCO-layout tree of palette masks with classes above 20 and the ignore
value 255. Both files hold the same arrays, the stored .npy members equal
byte for byte, and the tools print the same lines."""
import importlib.util
import os
import sys
import zipfile

import numpy as np
import pytest

from excel_tpu_torch.cli import make_cls_labels
from excel_tpu_torch.data.synthetic import make_coco_tree, make_voc_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_make_cls_labels", os.path.join(ROOT, "tools",
                                            "make_cls_labels.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_both(tmp_path, flags, monkeypatch, capsys):
    """(port's .npz members, JAX tool's .npz members), each {name: raw
    bytes}, after both tools ran with `flags`; their printed lines equal
    but for the output path."""
    outs, printed = [], []
    for which in ("port", "jax"):
        out = str(tmp_path / f"{which}.npz")
        argv = flags + ["--out", out]
        if which == "port":
            make_cls_labels.main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["make_cls_labels.py"] + argv)
            _jax_tool().main()
        printed.append(capsys.readouterr().out.replace(out, "OUT"))
        with zipfile.ZipFile(out) as z:
            outs.append({n: z.read(n) for n in z.namelist()})
    assert printed[0] == printed[1]
    return outs


@pytest.mark.parametrize("seed,num_fg", [(0, None), (3, "7")])
def test_voc_tree_matches_jax_tool(tmp_path, monkeypatch, capsys, seed,
                                   num_fg):
    root = str(tmp_path / "voc")
    split_dir = make_voc_tree(root, num_images=5, seed=seed,
                              num_fg=int(num_fg or 20), size_range=(32, 64))
    flags = ["--dataset", "voc", "--data-root", root, "--split-dir",
             split_dir, "--splits", "train_aug", "val"]
    if num_fg:
        flags += ["--num-fg", num_fg]
    port, ref = _run_both(tmp_path, flags, monkeypatch, capsys)
    assert sorted(port) == ["labels.npy", "names.npy"]
    assert port == ref
    with np.load(str(tmp_path / "port.npz")) as z:
        names, labels = z["names"], z["labels"]
    assert labels.dtype == np.uint8 and labels.shape == (10, int(num_fg or 20))
    assert list(names[:5]) == list(names[5:])
    # the labels are the masks' classes, as the tree's own file lists them
    with np.load(os.path.join(split_dir, "cls_labels.npz")) as z:
        np.testing.assert_array_equal(labels[:5], z["labels"])


def test_coco_tree_matches_jax_tool(tmp_path, monkeypatch, capsys):
    root = str(tmp_path / "coco")
    make_coco_tree(root, "train", num_images=4, seed=1, size_range=(32, 64))
    split_dir = make_coco_tree(root, "val", num_images=3, seed=2,
                               size_range=(32, 64))
    flags = ["--dataset", "coco", "--data-root", root, "--split-dir",
             split_dir, "--splits", "train", "val"]
    port, ref = _run_both(tmp_path, flags, monkeypatch, capsys)
    assert port == ref
    with np.load(str(tmp_path / "port.npz")) as z:
        names, labels = z["names"], z["labels"]
    assert labels.shape == (7, 80) and labels.dtype == np.uint8
    assert names[0].startswith("COCO_train2014_")
    assert names[-1] == "COCO_val2014_000000000003"
    assert labels[:, 20:].any()          # classes above VOC's 20
