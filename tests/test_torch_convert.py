"""The port's weight converters (excel_tpu_torch.cli.convert_clip,
convert_head; models.params.convert_torch_state_dict, infer_clip_config;
models.excel.convert_torch_head) against the JAX package's: an OpenAI-layout
CLIP state dict made from seeded random parameters, saved by `torch.save`
and as a `torch.jit` archive, and a `module.`-prefixed reference head
checkpoint with the frozen CLIP keys; both packages' CLIs write `.npz`
files with the same keys and equal arrays, which the port reads back."""
import numpy as np
import pytest
import torch

from excel_tpu.cli import convert_clip as jax_convert_clip
from excel_tpu.cli import convert_head as jax_convert_head
from excel_tpu.config import tiny_config
from excel_tpu_torch.cli import convert_clip, convert_head
from excel_tpu_torch.config import tiny_config as port_tiny_config
from excel_tpu_torch.engine.checkpoint import load_head_npz
from excel_tpu_torch.models.params import (_leaves, infer_clip_config,
                                           load_params_npz)
from torch_port_common import jax_clip_tree, jax_head_tree, port_head


# the fields of ClipConfig that a state dict's shapes determine
ARCH_FIELDS = ("patch_size", "vision_width", "vision_layers", "vision_heads",
               "embed_dim", "pretrain_grid", "context_length", "vocab_size",
               "text_width", "text_heads", "text_layers")


def _ln(sd, prefix, ln):
    sd[prefix + ".weight"], sd[prefix + ".bias"] = ln["scale"], ln["bias"]


def _block_to_torch(sd, prefix, blk):
    """The inverse of `_block_from_torch`: OpenAI names, [out, in] weights."""
    _ln(sd, prefix + ".ln_1", blk["ln_1"])
    _ln(sd, prefix + ".ln_2", blk["ln_2"])
    for name, (sub, key) in {"attn.in_proj_": ("attn", "qkv"),
                             "attn.out_proj.": ("attn", "out"),
                             "mlp.c_fc.": ("mlp", "fc"),
                             "mlp.c_proj.": ("mlp", "proj")}.items():
        sd[f"{prefix}.{name}weight"] = blk[sub][key]["w"].T
        sd[f"{prefix}.{name}bias"] = blk[sub][key]["b"]


def openai_state_dict(tree: dict) -> dict:
    """{name: torch tensor} in OpenAI CLIP's layout of a JAX-layout tree,
    with the three integer entries OpenAI's archives carry."""
    v, t = tree["visual"], tree["text"]
    sd = {"visual.conv1.weight": v["patch_embed"].transpose(3, 2, 0, 1),
          "visual.class_embedding": v["class_embedding"],
          "visual.positional_embedding": v["positional_embedding"],
          "visual.proj": v["proj"],
          "token_embedding.weight": t["token_embedding"],
          "positional_embedding": t["positional_embedding"],
          "text_projection": t["text_projection"],
          "logit_scale": tree["logit_scale"]}
    _ln(sd, "visual.ln_pre", v["ln_pre"])
    _ln(sd, "visual.ln_post", v["ln_post"])
    _ln(sd, "ln_final", t["ln_final"])
    for i, blk in enumerate(v["blocks"]):
        _block_to_torch(sd, f"visual.transformer.resblocks.{i}", blk)
    for i, blk in enumerate(t["blocks"]):
        _block_to_torch(sd, f"transformer.resblocks.{i}", blk)
    out = {k: torch.from_numpy(np.array(a, np.float32, order="C"))
           for k, a in sd.items()}
    out.update(input_resolution=torch.tensor(64),
               context_length=torch.tensor(16), vocab_size=torch.tensor(512))
    return out


class _Holder(torch.nn.Module):
    """A module whose state dict holds the given tensors under their
    dotted names (buffers of nested submodules)."""

    def __init__(self, tensors: dict):
        super().__init__()
        for key, value in tensors.items():
            node = self
            *path, leaf = key.split(".")
            for part in path:
                if not hasattr(node, part):
                    node.add_module(part, torch.nn.Module())
                node = getattr(node, part)
            node.register_buffer(leaf, value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


@pytest.fixture(scope="module")
def clip_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("convert")
    tree = jax_clip_tree(tiny_config().clip, seed=3)
    sd = openai_state_dict(tree)
    plain = str(tmp / "plain.pt")
    torch.save(sd, plain)
    jit = str(tmp / "jit.pt")
    torch.jit.save(torch.jit.script(_Holder(sd)), jit)
    return tmp, tree, sd, {"plain": plain, "jit": jit}


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_files_equal(a, b):
    za, zb = _npz(a), _npz(b)
    assert sorted(za) == sorted(zb)
    for k in za:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.mark.parametrize("kind", ["plain", "jit"])
def test_convert_clip_matches_jax(clip_files, kind):
    tmp, tree, sd, files = clip_files
    assert convert_clip._is_jit_archive(files[kind]) == (kind == "jit")
    loaded = convert_clip.load_torch_state_dict(files[kind])
    assert sorted(loaded) == sorted(sd)
    port, ref = str(tmp / f"port_{kind}.npz"), str(tmp / f"jax_{kind}.npz")
    cfg = convert_clip.main([files[kind], port])
    jax_convert_clip.main([files[kind], ref])
    _assert_files_equal(port, ref)
    # the tiny widths' heads are 32 wide; the converters infer width / 64,
    # ViT-B/16's (next test)
    ref_cfg = port_tiny_config().clip
    for field in ARCH_FIELDS:
        if not field.endswith("heads"):
            assert getattr(cfg, field) == getattr(ref_cfg, field), field
    assert (cfg.vision_heads, cfg.text_heads) == (1, 0)
    # the file holds the seeded tree, and the port reads it back
    leaves = {k: np.asarray(a) for k, a in _npz(port).items()}
    from excel_tpu_torch.models.params import _keystr
    assert leaves.keys() == {_keystr(p) for p, _ in _leaves(tree)}
    for p, a in _leaves(tree):
        np.testing.assert_array_equal(leaves[_keystr(p)], a)
    params = load_params_npz(port, cfg, device="cpu")
    np.testing.assert_array_equal(
        params["visual"]["blocks"][1]["attn"]["qkv"]["w"].numpy(),
        tree["visual"]["blocks"][1]["attn"]["qkv"]["w"].T)


def test_infer_clip_config_of_vit_b16_shapes():
    """The architecture read from ViT-B/16's shapes alone (no values)."""
    shapes = {"visual.conv1.weight": (768, 3, 16, 16),
              "visual.positional_embedding": (197, 768),
              "positional_embedding": (77, 512),
              "text_projection": (512, 512),
              "token_embedding.weight": (49408, 512)}
    sd = {k: np.empty(s, np.float32) for k, s in shapes.items()}
    for i in range(12):
        sd[f"visual.transformer.resblocks.{i}.ln_1.weight"] = np.empty(1)
        sd[f"transformer.resblocks.{i}.ln_1.weight"] = np.empty(1)
    from excel_tpu_torch.config import voc_config

    got, ref = infer_clip_config(sd), voc_config().clip
    for field in ARCH_FIELDS:
        assert getattr(got, field) == getattr(ref, field), field


def reference_head_state_dict(head: dict, clip_sd: dict) -> dict:
    """A `model_iter_*.pth`-like DDP state dict: the head's reference names
    ([out, in] linears, [out, in, 1, 1] 1x1 convolutions) and the frozen
    CLIP keys, all `module.`-prefixed."""
    sd = {}

    def lin(name, p):
        sd[name + ".weight"], sd[name + ".bias"] = p["w"].T, p["b"]

    def conv(name, p):
        sd[name + ".weight"] = p["w"].T[:, :, None, None]
        sd[name + ".bias"] = p["b"]

    for i, m in enumerate(head["fuse_mlps"]):
        lin(f"decoder_fts_fuse.linears_modulelist.{i}.proj", m["proj"])
        lin(f"decoder_fts_fuse.linears_modulelist.{i}.proj_2", m["proj2"])
    conv("decoder_fts_fuse.linear_fuse", head["linear_fuse"])
    conv("decoder.linear_pred", head["classifier"])
    for i, blk in enumerate(head["decoder"]):
        _block_to_torch(sd, f"decoder.transformer.resblocks.{i}", blk)
    out = {"module." + k: torch.from_numpy(np.array(a, order="C"))
           for k, a in sd.items()}
    out.update({"module.encoder." + k: v for k, v in clip_sd.items()})
    return out


def test_convert_head_matches_jax(clip_files, monkeypatch):
    """Both CLIs on one checkpoint at the tiny head's geometry (the voc
    preset patched to the tiny config in both packages): equal files,
    which the port loads as the head it was made from."""
    import excel_tpu.config as jcfg_mod
    import excel_tpu_torch.config as pcfg_mod

    tmp, _, sd, _ = clip_files
    head = jax_head_tree(tiny_config(), seed=4)
    path = str(tmp / "model_iter_4.pth")
    torch.save(reference_head_state_dict(head, sd), path)
    monkeypatch.setattr(jcfg_mod, "voc_config", tiny_config)
    monkeypatch.setattr(pcfg_mod, "voc_config", port_tiny_config)
    port, ref = str(tmp / "head_port.npz"), str(tmp / "head_jax.npz")
    convert_head.main([path, port])
    jax_convert_head.main([path, ref])
    _assert_files_equal(port, ref)
    cfg = port_tiny_config()
    got = load_head_npz(port, cfg.head, cfg.num_classes, device="cpu")
    want = port_head(head, cfg)
    for name, value in got.state_dict().items():
        assert torch.equal(value, want.state_dict()[name]), name
