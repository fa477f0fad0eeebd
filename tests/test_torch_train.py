"""The port's training (excel_tpu_torch.engine.train and .checkpoint)
against the JAX package's at tiny-config size on the CPU: the learning-rate
schedules, the optimizers from identical gradients, one train step per
phase (dropout off), the step cache, checkpoints and the head's `.npz`
files in both directions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from excel_tpu.config import tiny_config
from excel_tpu.engine import train as jtr
from excel_tpu_torch.config import tiny_config as port_tiny_config
from excel_tpu_torch.engine import checkpoint as pck
from excel_tpu_torch.engine import train as ptr
from torch_port_common import (jax_clip_tree, jax_head_tree,
                               jax_interpret_cfg, n, port_head, port_params,
                               t, train_batch)

KINDS = ("poly", "cos", "poly_sgd")
# both packages evaluate the schedule in float32; numpy's float32 cos and
# pow may differ from XLA's by an ulp
LR_RTOL = 1e-6
# the same gradients through optax and torch.optim for 3 steps: the two
# order their fp32 ops differently (sqrt(v / bc2) against sqrt(v) /
# sqrt(bc2), the decay folded in before or after): 1e-7, plus one fp32 ulp
# of the value for the LayerNorm scales near 1, whose ulp (1.19e-7) is
# above it (observed: one such entry one ulp apart)
OPT_ATOL = 1e-7
OPT_RTOL = 2.0 ** -23
# one train step against JAX: losses to fp32 rounding of sums taken in
# another order
LOSS_RTOL = 1e-5
# head parameters after 2 steps, except the entries whose gradient is
# below ADAM_NOISE_GRAD (100 x Adam's eps) in a step: at most this share
PARAM_ATOL = 1e-5
ADAM_NOISE_GRAD = 1e-6
MAX_EXCLUDED = 0.02


def _cfgs(**train):
    jcfg, pcfg = jax_interpret_cfg(tiny_config()), port_tiny_config()
    jcfg = dataclasses.replace(
        jcfg, head=dataclasses.replace(jcfg.head, dropout=0.0),
        train=dataclasses.replace(jcfg.train, **train))
    pcfg = dataclasses.replace(
        pcfg, head=dataclasses.replace(pcfg.head, dropout=0.0),
        train=dataclasses.replace(pcfg.train, **train))
    return jcfg, pcfg


@pytest.mark.parametrize("kind", KINDS)
def test_lr_schedule_matches_jax(kind):
    jcfg, pcfg = _cfgs(schedule=kind)
    ref = jtr.lr_schedule(jcfg.train)
    got = ptr.lr_schedule(pcfg.train)
    for step in range(pcfg.train.max_iters + 1):
        np.testing.assert_allclose(got(step), float(ref(jnp.asarray(step))),
                                   rtol=LR_RTOL, err_msg=f"step {step}")


@pytest.mark.parametrize("kind", ("poly", "poly_sgd"))
def test_optimizer_matches_optax_on_identical_gradients(kind):
    """AdamW (poly) and SGD with momentum (poly_sgd) over 3 updates, fed
    the same gradients, separate optimizer numerics from gradient ones."""
    jcfg, pcfg = _cfgs(schedule=kind, warmup_iters=1)
    tree = jax_head_tree(jcfg)
    head = port_head(tree, pcfg)
    state = ptr.init_train_state(head, pcfg.train)
    opt = jtr.make_optimizer(jcfg.train)
    jhead = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = opt.init(jhead)
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.1,
            tree)
        updates, opt_state = opt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), opt_state, jhead)
        jhead = optax.apply_updates(jhead, updates)
        port_grads = port_head(grads, pcfg)
        for p, g in zip(head.parameters(), port_grads.parameters()):
            p.grad = g.detach().clone()
        for group in state.optimizer.param_groups:
            group["lr"] = ptr.lr_schedule(pcfg.train)(state.step)
        state.optimizer.step()
        state.step += 1
    ref = port_head(jax.device_get(jhead), pcfg).state_dict()
    for name, value in head.state_dict().items():
        np.testing.assert_allclose(n(value), n(ref[name]), atol=OPT_ATOL,
                                   rtol=OPT_RTOL, err_msg=name)


@pytest.fixture(scope="module")
def train_setup():
    jcfg, pcfg = _cfgs()
    clip = jax_clip_tree(jcfg.clip, seed=0)
    head = jax_head_tree(jcfg, seed=1)
    images, cls, text = train_batch(jcfg, 4, seed=0)
    return jcfg, pcfg, clip, head, images, cls, text


PHASES = [(False, False), (True, False), (True, True)]
# The pseudo-labels are an argmax: where two scores tie within ~1e-6 (a
# random-weight model's class maps peak in the same grid cells, and the
# background crosses each class at 0.5), an ulp of difference upstream
# moves the pixel. Each step's pseudo-labels of the port are therefore
# counted against the JAX step's own, within this bound (0.5% of the
# 4 x 64 x 64 pixels; observed 6 to 11), and then both steps go on from
# the JAX step's labels, so that the losses, gradients and updates compare
# on the same targets.
MAX_DIFFERING_PSEUDO = 82


@pytest.fixture(scope="module")
def two_steps(train_setup):
    """{phase: (jax metrics, port metrics, jax head, port head, differing
    pseudo-label pixels per step)} after two steps of each phase from the
    same state (the first at the warmup's tiny rate, the second at 5e-4).
    The JAX side runs its attention kernels in interpret mode: their sums
    in the order the port's plain versions take them."""
    jcfg, pcfg, clip, head, images, cls, text = train_setup
    pclip = port_params(clip, pcfg.clip)
    recorded, differing = [], []
    jax_pseudo, port_pseudo = jtr.pseudo_labels, ptr.pseudo_labels

    def record(*args, **kwargs):
        out = jax_pseudo(*args, **kwargs)
        jax.debug.callback(lambda x: recorded.append(np.asarray(x)), out)
        return out

    def replay(*args, **kwargs):
        own = port_pseudo(*args, **kwargs)
        ref = torch.from_numpy(recorded.pop().copy())
        differing.append(int((own != ref).sum()))
        return ref

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "pseudo_labels", record)
        mp.setattr(ptr, "pseudo_labels", replay)
        for cal, seg in PHASES:
            fn = jtr.compiled_train_step(jcfg, calibrated=cal,
                                         seg_affinity=seg, donate=False)
            js = jtr.init_train_state(
                jax.tree_util.tree_map(jnp.asarray, head), jcfg.train)
            ps = ptr.init_train_state(port_head(head, pcfg), pcfg.train)
            jm, pm, differing[:] = [], [], []
            small = {}
            for i in range(2):
                js, m = fn(js, clip, jnp.asarray(images), jnp.asarray(cls),
                           jnp.asarray(text), jax.random.PRNGKey(i))
                jm.append({k: float(v) for k, v in m.items()})
                ps, m = ptr.train_step(ps, pclip, t(images), t(cls), t(text),
                                       None, pcfg, calibrated=cal,
                                       seg_affinity=seg)
                pm.append(m)
                for name, p in ps.head.named_parameters():
                    g = n(p.grad)
                    small[name] = small.get(name, False) | (
                        np.abs(g) < ADAM_NOISE_GRAD)
            out[cal, seg] = (jm, pm, jax.device_get(js.head), ps,
                             list(differing), small)
    return out


@pytest.mark.parametrize("phase", PHASES)
def test_train_step_matches_jax(two_steps, train_setup, phase):
    """Losses of both steps and the head after them. Adam moves an entry by
    lr * g / (|g| + 1e-8) in its first step: where |g| is near eps, the
    move turns on the gradient's value, and the rounding noise of a
    gradient that cancels to near 0 moves it differently in the two
    packages (the decoder's key biases, whose true gradient is 0 because
    the softmax cancels q . b_k, are such entries). Entries whose gradient
    on the port's side fell below ADAM_NOISE_GRAD in either step are
    excluded from the parameter bound (at most MAX_EXCLUDED of them); every
    other entry is held to it."""
    pcfg = train_setup[1]
    jm, pm, jhead, ps, differing, small = two_steps[phase]
    assert len(differing) == 2
    assert max(differing) <= MAX_DIFFERING_PSEUDO, differing
    for j, p in zip(jm, pm):
        for key in ("loss", "seg_loss", "diver_loss"):
            np.testing.assert_allclose(p[key], j[key], rtol=LOSS_RTOL,
                                       err_msg=key)
        np.testing.assert_allclose(p["lr"], j["lr"], rtol=LR_RTOL)
    assert ps.step == 2
    ref = port_head(jhead, pcfg).state_dict()
    total = sum(m.size for m in small.values())
    assert sum(int(m.sum()) for m in small.values()) <= MAX_EXCLUDED * total
    for name, value in ps.head.state_dict().items():
        keep = ~small[name]
        np.testing.assert_allclose(n(value)[keep], n(ref[name])[keep],
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_phases_and_step_cache():
    cfg = port_tiny_config()
    assert set(ptr.phased_train_steps(cfg)) == set(PHASES)
    assert ptr._phase(cfg, cfg.train.lvc_calibrate_iter - 1) == (False,
                                                                 False)
    assert ptr._phase(cfg, cfg.train.seg_affinity_iter) == (True, True)
    cache = ptr.TrainStepCache(cfg, buckets=(2, 4))
    cls = np.zeros((4, cfg.num_fg), np.float32)
    cls[:, 0] = 1.0
    assert cache.slots_for(cls) == 2
    cls[0, :3] = 1.0
    assert cache.slots_for(cls) == 4
    cls[0, :] = 1.0
    assert cache.slots_for(cls) is None
    assert cache((True, False), cls) is cache((True, False), cls)
    assert cache((True, False), cls).keywords["class_slots"] is None
    # the JAX package's default buckets (4, 8) cut at num_fg = 5
    assert ptr.TrainStepCache(cfg).buckets == jtr.TrainStepCache(
        tiny_config()).buckets == (4,)


def test_checkpoint_round_trip(train_setup, tmp_path):
    """A state saved after one step and restored into a fresh state takes
    the same second step as the original."""
    _, pcfg, clip, head, images, cls, text = train_setup
    pclip = port_params(clip, pcfg.clip)
    args = (pclip, t(images), t(cls), t(text), None, pcfg)
    kw = dict(calibrated=False, seg_affinity=False)
    state = ptr.init_train_state(port_head(head, pcfg), pcfg.train)
    state, _ = ptr.train_step(state, *args, **kw)
    assert pck.latest_checkpoint(str(tmp_path)) is None
    pck.save_checkpoint(str(tmp_path), state)
    path = pck.latest_checkpoint(str(tmp_path))
    assert path.endswith("step_1.pt")
    fresh = ptr.init_train_state(port_head(jax_head_tree(tiny_config(), 7),
                                           pcfg), pcfg.train)
    fresh = pck.restore_checkpoint(path, fresh)
    assert fresh.step == 1
    state, m1 = ptr.train_step(state, *args, **kw)
    fresh, m2 = ptr.train_step(fresh, *args, **kw)
    assert m1 == m2
    for a, b in zip(state.head.parameters(), fresh.head.parameters()):
        assert torch.equal(a, b)


def test_head_npz_both_ways(train_setup, tmp_path):
    """The JAX package writes and the port reads, then the port writes and
    the JAX package reads: the same arrays."""
    from excel_tpu.engine.checkpoint import load_head_npz, save_head_npz

    jcfg, pcfg, _, head, *_ = train_setup
    jhead = jax.tree_util.tree_map(jnp.asarray, head)
    save_head_npz(str(tmp_path / "jax.npz"), jhead)
    got = pck.load_head_npz(str(tmp_path / "jax.npz"), pcfg.head,
                            pcfg.num_classes, device="cpu")
    ref = port_head(head, pcfg).state_dict()
    for name, value in got.state_dict().items():
        assert torch.equal(value, ref[name]), name
    pck.save_head_npz(str(tmp_path / "port.npz"), got)
    back = load_head_npz(str(tmp_path / "port.npz"), jhead)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jhead)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_step_returns_device_scalars(train_setup):
    """The losses come back as 0-d tensors on the step's device, equal to
    the losses of the step's own forward (what `.item()` read before), and
    the step itself reads no loss on the host."""
    import inspect

    assert ".item()" not in inspect.getsource(ptr.train_step)
    _, pcfg, clip, head, images, cls, text = train_setup
    pclip = port_params(clip, pcfg.clip)
    for cal, seg in PHASES:
        kw = dict(calibrated=cal, seg_affinity=seg)
        state = ptr.init_train_state(port_head(head, pcfg), pcfg.train)
        total, l_seg, l_aff, _ = ptr.train_losses(
            state.head, pclip, t(images), t(cls), t(text), None, pcfg, **kw)
        state, m = ptr.train_step(state, pclip, t(images), t(cls), t(text),
                                  None, pcfg, **kw)
        for key, ref in (("loss", total), ("seg_loss", l_seg),
                         ("diver_loss", l_aff)):
            assert isinstance(m[key], torch.Tensor) and m[key].dim() == 0
            assert m[key].device == t(images).device
            assert not m[key].requires_grad
            assert float(m[key]) == float(ref), key
        assert isinstance(m["lr"], float)
