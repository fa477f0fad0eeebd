"""Port SVC (excel_tpu_torch.ops.affinity) against the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from excel_tpu.ops import affinity as jaff
from excel_tpu_torch.ops import affinity as paff
from torch_port_common import n, t


def _score_maps(seed, m=6, h=20, w=20):
    """Min-max normalised maps with a few blobs, some touching the edges
    (the box-clip quirk) and one flat map."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    maps = []
    for i in range(m):
        s = 0.2 * rng.random((h, w))
        for _ in range(int(rng.integers(1, 4))):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            r = rng.integers(2, 7)
            s += np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2.0 * r * r))
        s = (s - s.min()) / (s.max() - s.min())
        maps.append(s if i < m - 1 else np.zeros((h, w)))
    return np.stack(maps).astype(np.float32)


def test_compute_trans_mat_matches():
    a = np.random.default_rng(0).random((2, 16, 16), dtype=np.float32) + 0.01
    ref = np.stack([np.asarray(jaff.compute_trans_mat(jnp.asarray(x)))
                    for x in a])
    np.testing.assert_allclose(n(paff.compute_trans_mat(t(a))), ref,
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_propagate_labels_and_box_mask_exact(seed):
    maps = _score_maps(seed)
    binary = maps > 0.5
    ref_lab = np.stack([np.asarray(jaff._propagate_labels(jnp.asarray(b)))
                        for b in binary])
    np.testing.assert_array_equal(n(paff._propagate_labels(t(binary))),
                                  ref_lab)
    for thr in (0.79, 0.5):
        ref = np.stack([np.asarray(jaff.scoremap_box_mask(jnp.asarray(s),
                                                          thr))
                        for s in maps])
        np.testing.assert_array_equal(
            n(paff.scoremap_box_mask(t(maps), thr)), ref)


def test_aggregate_attn_matches():
    rng = np.random.default_rng(3)
    aw = rng.random((2, 4, 17, 17), dtype=np.float32)
    seg = rng.random((2, 16, 16), dtype=np.float32)
    for s in (None, seg):
        ref = np.stack([np.asarray(jaff.aggregate_attn(
            jnp.asarray(aw[i]), 3,
            None if s is None else jnp.asarray(s[i]))) for i in range(2)])
        got = paff.aggregate_attn(t(aw), 3, None if s is None else t(s))
        np.testing.assert_allclose(n(got), ref, rtol=1e-6, atol=1e-7)


def test_refine_lams_batch_stack_and_mean_match():
    """Both attention forms; the LAMs are identical inputs, so the uint8
    box masks agree exactly and only the products' rounding differs."""
    rng = np.random.default_rng(4)
    lams = _score_maps(5, m=6, h=4, w=4).reshape(2, 3, 16)
    stack = rng.random((3, 2, 17, 17), dtype=np.float32)
    for attn in (stack, stack.mean(axis=0)):
        ref = jaff.refine_lams_batch(jnp.asarray(lams), jnp.asarray(attn),
                                     0.79, (4, 4), attn_layers=3)
        got = paff.refine_lams_batch(t(lams), t(attn), 0.79, (4, 4),
                                     attn_layers=3)
        np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-5,
                                   atol=1e-7)
    with pytest.raises(ValueError):
        paff.refine_lams_batch(t(lams), t(stack.mean(axis=0)), 0.79, (4, 4),
                               seg_attn=t(np.ones((2, 16, 16), np.float32)))


def _propagate_every_sweep(mask):
    """The propagation as it tested convergence after every sweep (one
    device wait a sweep): the reference for the batched test."""
    import torch

    m, h, w = mask.shape
    big = h * w
    lab = torch.where(mask, torch.arange(big).reshape(1, h, w),
                      torch.full((1, h, w), big))
    sweeps = 0
    while True:
        p = torch.nn.functional.pad(lab, (1, 1, 1, 1), value=big)
        neigh = torch.stack([p[:, dy:dy + h, dx:dx + w]
                             for dy in range(3) for dx in range(3)])
        new = torch.where(mask, neigh.amin(dim=0), big)
        sweeps += 1
        if torch.equal(new, lab):
            return lab, sweeps
        lab = new


def _masks(h=20, w=24):
    """A serpentine (one component along which the smallest label walks
    ~h/2 x w sweeps), a comb, an empty and a full mask."""
    snake = np.zeros((h, w), bool)
    snake[::2] = True
    for r in range(1, h, 2):
        snake[r, w - 1 if r % 4 == 1 else 0] = True
    comb = np.zeros((h, w), bool)
    comb[0] = True
    comb[:, ::3] = True
    comb[h // 2, 1::3] = True
    return np.stack([snake, comb, np.zeros((h, w), bool),
                     np.ones((h, w), bool)])


def test_propagate_labels_tests_convergence_every_k_sweeps(monkeypatch):
    """Labels equal to the every-sweep loop's and to the JAX package's on
    masks that need many sweeps, with one convergence test (one device
    wait) per SWEEPS_PER_TEST sweeps."""
    import torch

    masks = t(_masks())
    ref, sweeps = _propagate_every_sweep(masks)
    assert sweeps > 100
    tests = []
    real_equal = torch.equal
    monkeypatch.setattr(torch, "equal",
                        lambda a, b: tests.append(1) or real_equal(a, b))
    got = paff._propagate_labels(masks)
    monkeypatch.undo()
    np.testing.assert_array_equal(n(got), n(ref))
    # the fixed point holds after sweeps - 1 sweeps; the first test after it
    # that compares two labellings past it ends the loop
    assert len(tests) == -(-(sweeps - 1) // paff.SWEEPS_PER_TEST) + 1
    jax_lab = np.stack([np.asarray(jaff._propagate_labels(jnp.asarray(b)))
                        for b in _masks()])
    np.testing.assert_array_equal(n(got), jax_lab)
    # one component each for the serpentine, the comb and the full mask
    for i in (0, 1, 3):
        assert len(np.unique(n(got[i])[_masks()[i]])) == 1
    assert (n(got[2]) == masks.shape[1] * masks.shape[2]).all()
