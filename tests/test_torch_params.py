"""Port parameters: conversion from the JAX tree and npz files, exact."""
import jax
import numpy as np
import pytest

from excel_tpu.config import tiny_config
from excel_tpu.models.params import save_params_npz
from excel_tpu_torch.config import tiny_config as port_tiny_config
from excel_tpu_torch.models.params import (from_jax_params, init_clip_params,
                                           load_params_npz)
from torch_port_common import jax_clip_tree, n


def _expected(path, leaf):
    leaf = np.asarray(leaf)
    if path[-1] == "patch_embed":
        return leaf.transpose(3, 2, 0, 1)
    if path[-1] == "w" and path[-2] in ("qkv", "out", "fc", "proj"):
        return leaf.T
    return leaf


def _walk(jx, pt, path=()):
    if isinstance(jx, dict):
        assert set(jx) == set(pt), path
        for key in jx:
            yield from _walk(jx[key], pt[key], path + (key,))
    elif isinstance(jx, (list, tuple)):
        assert len(jx) == len(pt), path
        for i, (a, b) in enumerate(zip(jx, pt)):
            yield from _walk(a, b, path + (i,))
    else:
        yield path, jx, pt


def test_from_jax_params_exact():
    cfg = tiny_config().clip
    tree = jax_clip_tree(cfg)
    port = from_jax_params(tree, port_tiny_config().clip, device="cpu")
    leaves = list(_walk(tree, port))
    assert len(leaves) == len(jax.tree_util.tree_leaves(tree))
    for path, jx, pt in leaves:
        np.testing.assert_array_equal(n(pt), _expected(path, jx),
                                      err_msg=str(path))
        assert pt.is_contiguous()


def test_load_params_npz_matches_from_jax(tmp_path):
    cfg = tiny_config().clip
    tree = jax_clip_tree(cfg, seed=3)
    path = str(tmp_path / "clip.npz")
    save_params_npz(path, tree)
    a = load_params_npz(path, port_tiny_config().clip, device="cpu")
    b = from_jax_params(tree, port_tiny_config().clip, device="cpu")
    for path_, x, y in _walk(a, b):
        np.testing.assert_array_equal(n(x), n(y), err_msg=str(path_))


def test_init_clip_params_layout_matches_jax_shapes():
    """Random init has the shapes the JAX tree converts to."""
    cfg = tiny_config().clip
    tree = jax_clip_tree(cfg)
    port = init_clip_params(port_tiny_config().clip, device="cpu")
    for path, jx, pt in _walk(tree, port):
        assert tuple(pt.shape) == _expected(path, jx).shape, path


def test_from_jax_params_rejects_wrong_depth():
    tree = jax_clip_tree(tiny_config().clip)
    cfg = port_tiny_config().clip
    import dataclasses
    with pytest.raises(ValueError):
        from_jax_params(tree, dataclasses.replace(cfg, vision_layers=3),
                        device="cpu")


def test_cast_matmul_weights_matches_jax():
    """Only the 'w'/'b' leaves go to bf16 (the same values as the JAX
    package's cast); LayerNorm, embedding and projection leaves stay
    fp32."""
    import jax.numpy as jnp
    import torch

    from excel_tpu.models.params import cast_matmul_weights as jax_cast
    from excel_tpu_torch.models.params import cast_matmul_weights

    tree = jax_clip_tree(tiny_config().clip)
    ref = jax_cast(tree, jnp.bfloat16)
    got = cast_matmul_weights(
        from_jax_params(tree, port_tiny_config().clip, device="cpu"),
        torch.bfloat16)
    n_bf16 = 0
    for path, jx, pt in _walk(ref, got):
        want = torch.bfloat16 if path[-1] in ("w", "b") else torch.float32
        assert pt.dtype == want, path
        n_bf16 += pt.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            n(pt.float()), _expected(path, np.asarray(jx, np.float32)),
            err_msg=str(path))
    assert n_bf16 > 0
