"""The port's ModifiedResNet tower (excel_tpu_torch/models/resnet.py)
against excel_tpu/models/resnet.py: the same OpenAI-named state dict, made
with numpy from a seed with its BatchNorm statistics randomised, through
both packages' converters; the forward at the pretrained size, at larger
(upsampled positional grid), smaller (antialiased downsampling) and
non-square inputs, within 1e-4 of the JAX output's largest magnitude."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from excel_tpu.models import resnet as jres
from excel_tpu_torch.models import resnet as pres

TOL_OF_MAX = 1e-4


def openai_resnet_state_dict(layers, width, heads, embed, image_size,
                             seed: int) -> dict:
    """An OpenAI RN-layout ('visual.' prefix) state dict of seeded normal
    weights, BatchNorm running means N(0, 0.5) and variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def w(key, *shape, std=None):
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        std = std or fan_in ** -0.5
        sd[key] = (rng.standard_normal(shape) * std).astype(np.float32)

    def bn(prefix, c):
        sd[prefix + ".weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[prefix + ".bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[prefix + ".running_mean"] = rng.normal(0, 0.5, c).astype(
            np.float32)
        sd[prefix + ".running_var"] = rng.uniform(0.5, 1.5, c).astype(
            np.float32)
        sd[prefix + ".num_batches_tracked"] = np.zeros((), np.int64)

    half = width // 2
    for i, (cout, cin) in enumerate(((half, 3), (half, half),
                                     (width, half)), start=1):
        w(f"visual.conv{i}.weight", cout, cin, 3, 3)
        bn(f"visual.bn{i}", cout)
    inplanes = width
    for li, n_blocks in enumerate(layers, start=1):
        planes = width * 2 ** (li - 1)
        for bi in range(n_blocks):
            pre = f"visual.layer{li}.{bi}"
            stride = 1 if li == 1 or bi > 0 else 2
            w(pre + ".conv1.weight", planes, inplanes, 1, 1)
            bn(pre + ".bn1", planes)
            w(pre + ".conv2.weight", planes, planes, 3, 3)
            bn(pre + ".bn2", planes)
            w(pre + ".conv3.weight", planes * 4, planes, 1, 1)
            bn(pre + ".bn3", planes * 4)
            if stride > 1 or inplanes != planes * 4:
                w(pre + ".downsample.0.weight", planes * 4, inplanes, 1, 1)
                bn(pre + ".downsample.1", planes * 4)
            inplanes = planes * 4
    feat = width * 32
    grid = image_size // 32
    ap = "visual.attnpool"
    w(ap + ".positional_embedding", grid * grid + 1, feat, std=feat ** -0.5)
    for name, out in (("q_proj", feat), ("k_proj", feat), ("v_proj", feat),
                      ("c_proj", embed)):
        w(f"{ap}.{name}.weight", out, feat)
        sd[f"{ap}.{name}.bias"] = rng.normal(0, 0.02, out).astype(np.float32)
    return sd


TOWERS = {"tiny": dict(layers=(1, 1, 1, 1), width=16, heads=8, embed=32,
                       image_size=64, seed=0),
          "deeper": dict(layers=(2, 1, 2, 1), width=16, heads=8, embed=32,
                         image_size=64, seed=1)}


@pytest.fixture(scope="module", params=sorted(TOWERS))
def tower(request):
    spec = TOWERS[request.param]
    sd = openai_resnet_state_dict(**spec)
    jcfg = jres.infer_resnet_config(sd)
    pcfg = pres.infer_resnet_config(sd)
    jparams = jres.convert_resnet_tower(sd, jcfg)
    pparams = pres.convert_resnet_tower(sd, pcfg, device="cpu")
    return spec, sd, jcfg, pcfg, jparams, pparams


def test_config_inference_matches_jax(tower):
    spec, sd, jcfg, pcfg, _, _ = tower
    assert pres.is_resnet_state_dict(sd) == jres.is_resnet_state_dict(sd)
    assert pres.is_resnet_state_dict(sd)
    assert not pres.is_resnet_state_dict({"visual.conv1.weight": 0})
    assert not jres.is_resnet_state_dict({"visual.conv1.weight": 0})
    assert dataclass_fields(pcfg) == dataclass_fields(jcfg)
    assert pcfg.layers == spec["layers"] and pcfg.heads == spec["heads"]
    assert pcfg.feat_dim == jcfg.feat_dim
    assert pcfg.pretrain_grid == jcfg.pretrain_grid
    over = dict(image_size=96, heads=4)
    assert (dataclass_fields(pres.infer_resnet_config(sd, **over))
            == dataclass_fields(jres.infer_resnet_config(sd, **over)))


def dataclass_fields(cfg) -> dict:
    return {k: getattr(cfg, k) for k in
            ("layers", "width", "embed_dim", "heads", "image_size")}


@pytest.mark.parametrize("hw", [(64, 64), (96, 96), (32, 32), (64, 96)],
                         ids=["pretrained", "upsampled", "downsampled",
                              "non_square"])
def test_forward_matches_jax(tower, hw):
    spec, _, jcfg, pcfg, jparams, pparams = tower
    rng = np.random.default_rng(10 + hw[0] + hw[1])
    images = rng.uniform(-1.5, 1.5, (2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jres.resnet_forward, static_argnums=2)(
        jparams, jnp.asarray(images), jcfg))
    with torch.no_grad():
        got = pres.resnet_forward(pparams, torch.from_numpy(images),
                                  pcfg).numpy()
    tokens = 1 + (hw[0] // 32) * (hw[1] // 32)
    assert got.shape == ref.shape == (2, tokens, spec["embed"])
    assert np.isfinite(got).all()
    err = float(np.abs(got - ref).max())
    assert err <= TOL_OF_MAX * float(np.abs(ref).max()), err


def test_positional_grid_resize_antialiases():
    """The grid resized as `jax.image.resize(..., "bilinear")` resizes it,
    antialiased where an axis shrinks; the CLS row kept."""
    rng = np.random.default_rng(3)
    pos = rng.standard_normal((1 + 4 * 4, 8)).astype(np.float32)
    grid = jnp.asarray(pos[1:].reshape(4, 4, 8))
    for h, w in ((2, 2), (2, 6), (7, 3)):
        ref = np.asarray(jax.image.resize(grid, (h, w, 8), "bilinear"))
        got = pres.resize_pos_grid(torch.from_numpy(pos), h, w)
        np.testing.assert_array_equal(got[0].numpy(), pos[0])
        np.testing.assert_allclose(got[1:].numpy().reshape(h, w, 8), ref,
                                   rtol=0, atol=1e-6)
    # F.interpolate, which does not antialias, is another function here
    half = pres.resize_pos_grid(torch.from_numpy(pos), 2, 2)[1:]
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(pos[1:].reshape(1, 4, 4, 8)).permute(0, 3, 1, 2),
        size=(2, 2), mode="bilinear", align_corners=False)
    assert float((half - plain[0].permute(1, 2, 0).reshape(4, 8)).abs()
                 .max()) > 0.1


def test_jax_tree_route_equals_state_dict_route(tower):
    _, _, _, pcfg, jparams, pparams = tower
    via_jax = pres.from_jax_resnet_params(jax.device_get(jparams), pcfg,
                                          device="cpu")
    flat_a, flat_b = _flat(pparams), _flat(via_jax)
    assert flat_a.keys() == flat_b.keys()
    for k, a in flat_a.items():
        b = flat_b[k]
        assert a.dtype == b.dtype == torch.float32 and a.is_contiguous()
        assert torch.equal(a, b), k
    assert pparams["conv1"].shape[1:] == (3, 3, 3)            # OIHW
    with pytest.raises(ValueError, match="blocks"):
        pres.from_jax_resnet_params(jax.device_get(jparams),
                                    pres.ResNetClipConfig(layers=(9, 1, 1, 1)),
                                    device="cpu")


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (i,)))
        return out
    return {path: tree}


def test_default_device_needs_a_gpu(tower):
    _, sd, _, pcfg, jparams, _ = tower
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pres.convert_resnet_tower(sd, pcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pres.from_jax_resnet_params(jax.device_get(jparams), pcfg)
