"""EVA02-CLIP-L/14-336 as the port's backbone, on the CPU: the port's towers
against the benchmark's plain float32 reference of EVA-CLIP's
(portbench/reference/eva02.py), at a small EVA02-shaped size (width 128 in
2 heads of 64, SwiGLU hidden int(128 x 2.6667) = 341, no multiple of 8,
patch 14, grid 4: 56 px; rotary q/k from grid 16, sub-LayerNorms, eps
1e-6, no ln_pre) on seeded random weights; the rotary table against its
closed form; each of EVA-02's parts seen by the comparison; the named
backbone through config inference, the converter and a CLI; and the
OpenAI default bit for bit as it was.

Tolerances (relative to the largest magnitude of the compared output):
- float32, 1e-5: the same arithmetic summed in another order (the port
  batches images and heads, the reference takes one image and per-head
  products); the readings are below 2e-6;
- bfloat16, 0.03: the port rounds every product, the residual stream, the
  gate and the rotation to bfloat16 (2^-8 = 0.0039 a rounding) through 4
  blocks; the readings are below 0.013.
The float32 comparison is the one that holds EVA-02's parts: dropping any
one of them moves the output by more than 10 times the float32 tolerance
(test_the_comparison_sees_each_part; eps 1e-5 in place of 1e-6 the least,
1.9e-4; the others 0.025-0.83).
"""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from excel_tpu_torch import config as C
from excel_tpu_torch.config import tiny_config, with_backbone
from excel_tpu_torch.engine import evaluate
from excel_tpu_torch.models import clip as clip_mod
from excel_tpu_torch.models import layers
from excel_tpu_torch.models.excel import compute_lams
from excel_tpu_torch.models.params import (cast_matmul_weights,
                                           init_clip_params, pad_swiglu)
from portbench.harness import weights as W
from portbench.harness import weights_eva02
from portbench.reference import encoder as E
from portbench.reference import eva02 as R
from portbench.reference import openclip

torch.set_num_threads(1)

EVA = "eva02-clip-l-14-336"
TOL = {torch.float32: 1e-5, torch.bfloat16: 0.03}


def eva_tiny(dtype=torch.float32, **clip):
    cfg = with_backbone(tiny_config(), EVA, tiny=True)
    return dataclasses.replace(cfg, clip=dataclasses.replace(
        cfg.clip, compute_dtype=dtype, **clip))


def served(cfg, seed=11):
    """(the seeded tree as drawn, as the port serves it: the SwiGLU's
    hidden padded as its loaders pad it, the matmul weights cast in
    bf16)."""
    params = weights_eva02.clip_visual(cfg, seed, "cpu")
    serve = pad_swiglu(params)
    if cfg.compute_dtype == torch.bfloat16:
        serve = cast_matmul_weights(serve, torch.bfloat16)
    return params, serve


def rel_err(got, ref) -> float:
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max())


def images(b=2, size=56, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (b, size, size, 3), generator=g).float()


def reference(params, x, cfg):
    return R.vision_forward(params["visual"], x, cfg.vision_heads,
                            cfg.surgery_blocks, cfg.attn_out_layers,
                            rope_grid=16, eps=1e-6, stack=True)


def test_presets_are_eva02_shaped():
    c = eva_tiny().clip
    assert (c.vision_width // c.vision_heads, c.patch_size, c.grid, c.hidden,
            c.block, c.rope_grid, c.ln_eps) == \
        (64, 14, 4, 341, "eva02", 16, 1e-6)
    assert c.hidden % 8 and 2730 % 8
    full = with_backbone(C.fast(C.voc_config()), EVA)
    assert (full.clip.vision_width, full.clip.vision_heads,
            full.clip.vision_layers, full.clip.grid, full.clip.tokens,
            full.clip.hidden, full.clip.embed_dim, full.clip.pretrain_grid,
            full.clip.text_width, full.clip.text_heads,
            full.clip.compute_dtype) == \
        (1024, 16, 24, 24, 577, int(1024 * 2.6667), 768, 24, 768, 12,
         torch.bfloat16)
    assert (full.head.in_channels, full.head.num_blocks,
            full.data.crop_size) == (1024, 24, 336)
    default = C.ClipConfig()
    assert (default.block, default.hidden, default.rope_grid,
            default.ln_eps) == ("vit", 4 * 768, 0, 1e-5)


@pytest.mark.parametrize("attn_mode", ["stack", "mean", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_vision_forward_matches_reference(dtype, attn_mode):
    cfg = eva_tiny(dtype).clip
    params, serve = served(cfg)
    assert params["visual"]["blocks"][0]["mlp"]["fc"]["w"].shape == \
        (2 * 341, 128)
    assert serve["visual"]["blocks"][0]["mlp"]["fc"]["w"].shape == \
        (2 * 344, 128)
    x = E.normalize(images())
    out = clip_mod.vision_forward(serve, x, cfg, attn_mode=attn_mode)
    for i in range(x.shape[0]):
        ref = reference(params, x[i], cfg)
        proj = out["projected"][i].float()
        assert rel_err(proj / proj.norm(dim=0, keepdim=True),
                       ref["projected"]) <= TOL[dtype]
        assert rel_err(out["feats"][:, i], ref["feats"]) <= TOL[dtype]
        if attn_mode == "stack":
            assert rel_err(out["attn"][:, i], ref["stack"]) <= TOL[dtype]
        elif attn_mode == "mean":
            assert rel_err(out["attn"][i], ref["attn"]) <= TOL[dtype]
        else:
            assert out["attn"] is None


def _closed_form(grid, d, pt_grid):
    """cos and sin [grid^2, d] in float64 from the formula: dims [0, d/2)
    by the row, [d/2, d) by the column; pair i at (p / grid) pt_grid
    10000^(-2i / (d/2))."""
    half = d // 2
    cos = np.zeros((grid * grid, d))
    sin = np.zeros((grid * grid, d))
    for t in range(grid * grid):
        pos = (t // grid, t % grid)
        for dim in range(d):
            p = pos[dim // half]
            i = (dim % half) // 2
            ang = p / grid * pt_grid * 10000.0 ** (-2.0 * i / half)
            cos[t, dim], sin[t, dim] = math.cos(ang), math.sin(ang)
    return cos, sin


@pytest.mark.parametrize("grid", [24, 17, 36], ids=["336px", "msc0.7",
                                                    "msc1.5"])
def test_rope_table_is_the_closed_form(grid):
    """The port's table and the reference's at EVA02-L/14's grid 24 and at
    MSC scales' grids (336 x 0.7 and x 1.5 over patch 14), each within
    fp32's rounding of angles up to 35 rad (1e-5) of the float64 formula;
    the port's is the reference's, computed the same way."""
    table = layers.rope_table(16, grid, grid, 64)
    assert table.shape == (2, grid * grid, 64) and table.dtype == \
        torch.float32
    cos, sin = _closed_form(grid, 64, 16)
    assert np.abs(table[0].numpy() - cos).max() <= 1e-5
    assert np.abs(table[1].numpy() - sin).max() <= 1e-5
    r_cos, r_sin = R.rope_table(grid, 64, 16)
    assert torch.equal(table[0], r_cos) and torch.equal(table[1], r_sin)
    # pairs share their angle; the first patch (row 0, column 0) is not
    # turned
    assert torch.equal(table[:, :, 0::2], table[:, :, 1::2])
    assert torch.equal(table[0, 0], torch.ones(64))


def test_apply_rope_turns_pairs_and_leaves_cls():
    g = torch.Generator().manual_seed(0)
    t = torch.randn((2, 3, 17, 64), generator=g)
    rope = layers.rope_table(16, 4, 4, 64)
    out = layers.apply_rope(t, rope)
    assert torch.equal(out[:, :, 0], t[:, :, 0])
    x0, x1 = t[:, :, 1:, 0::2], t[:, :, 1:, 1::2]
    c, s = rope[0][:, 0::2], rope[1][:, 0::2]
    assert torch.allclose(out[:, :, 1:, 0::2], x0 * c - x1 * s, atol=1e-6)
    assert torch.allclose(out[:, :, 1:, 1::2], x1 * c + x0 * s, atol=1e-6)
    # a rotation keeps each pair's norm
    assert torch.allclose(out.norm(dim=-1), t.norm(dim=-1), atol=1e-5)


def _rope_from_cls(t, rope):
    """The table applied from the CLS token on: each patch turned by its
    predecessor's angles (an off-by-one the rotation must not have)."""
    body = t[:, :, :-1].float()
    body = body * rope[0] + layers._rotate_pairs(body) * rope[1]
    return torch.cat([body.to(t.dtype), t[:, :, -1:]], dim=2)


def _gate_without_ln(u, bias, ln, eps=1e-6):
    hp = u.shape[-1] // 2
    h = ln["scale"].shape[0]
    z = u + bias.to(u.dtype)
    m = torch.nn.functional.silu(z[..., :h]) * z[..., hp:hp + h]
    return torch.nn.functional.pad(m, (0, hp - h))


PARTS = {
    "rotation": dict(cfg=dict(rope_grid=0)),
    "rotation_at_cls": dict(patch=(layers, "apply_rope", _rope_from_cls)),
    "ln_inner": dict(drop_block=("attn", "ln_inner")),
    "ln_ffn": dict(patch=(layers, "swiglu_gate_fused", _gate_without_ln)),
    "eps_1e-5": dict(cfg=dict(ln_eps=1e-5)),
    "patch_bias": dict(drop="patch_bias"),
    "head_bias": dict(drop="proj_bias"),
}


@pytest.mark.parametrize("part", sorted(PARTS))
def test_the_comparison_sees_each_part(part, monkeypatch):
    """The port's fp32 tower with one of EVA-02's parts dropped (or the
    rotation misplaced onto the CLS token) against the full reference
    misses the float32 tolerance by more than 10 times, in `projected`
    or the feature stack, so the float32 comparisons hold every part."""
    spec = PARTS[part]
    cfg = eva_tiny(**spec.get("cfg", {})).clip
    _, params = served(eva_tiny().clip)
    if "patch" in spec:
        monkeypatch.setattr(*spec["patch"])
    if "drop" in spec:
        params = {"visual": {k: v for k, v in params["visual"].items()
                             if k != spec["drop"]}}
    if "drop_block" in spec:
        grp, key = spec["drop_block"]
        params["visual"]["blocks"] = [
            dict(b, **{grp: {k: v for k, v in b[grp].items() if k != key}})
            for b in params["visual"]["blocks"]]
    x = E.normalize(images(b=1))
    out = clip_mod.vision_forward(params, x, cfg, attn_mode="none")
    full, _ = served(eva_tiny().clip)
    ref = reference(full, x[0], eva_tiny().clip)
    proj = out["projected"][0].float()
    err = max(rel_err(proj / proj.norm(dim=0, keepdim=True),
                      ref["projected"]),
              rel_err(out["feats"][:, 0], ref["feats"]))
    assert err > 10 * TOL[torch.float32], err


def _reference_numbers(cfg, params, text):
    return {"visual": params["visual"], "text": text,
            "size": cfg.clip.image_size, "patch": cfg.clip.patch_size,
            "heads": cfg.clip.vision_heads,
            "surgery": cfg.clip.surgery_blocks,
            "window": cfg.clip.attn_out_layers, "num_fg": cfg.num_fg,
            "caa": cfg.refine.caa_threshold,
            "dilations": tuple(cfg.refine.par_dilations),
            "iters": cfg.refine.par_iters, "rope_grid": cfg.clip.rope_grid,
            "eps": cfg.clip.ln_eps}


@pytest.mark.parametrize("size", [56, 336], ids=["grid4", "grid24"])
def test_lams_and_hist_step_match_reference(size):
    """compute_lams and one training-free lam_eval_hist_step, at grid 4 and
    at EVA02-L/14's grid 24 (336 px, 577 tokens: the rotary table at 24
    and the positional table resized from 4): the LAMs within the float32
    tolerance, the hist within two pixels a differing label of the one
    from the reference's labels."""
    cfg = eva_tiny(image_size=size)
    params, serve = served(cfg.clip)
    text = W.text_bank(cfg.num_fg + 3, cfg.clip.embed_dim, 11, "cpu")
    img = images(size=size, seed=5)
    cls = torch.zeros(2, cfg.num_fg)
    cls[0, 1] = cls[1, 3] = cls[1, 4] = 1.0
    g = torch.Generator().manual_seed(6)
    gt = torch.randint(0, cfg.num_classes, (2, size, size), generator=g)
    valid = torch.tensor([[size, size]] * 2)
    out = clip_mod.encode_image(serve, evaluate.normalize_images(img),
                                cfg.clip, attn_mode="mean")
    lams = compute_lams(out, text, cfg.num_fg)
    hist = evaluate.lam_eval_hist_step(
        torch.zeros((cfg.num_classes,) * 2, dtype=torch.int64),
        {"clip": serve}, img, cls, gt, valid, text, cfg, (size, size))
    m = _reference_numbers(cfg, params, text)
    ref_hist = torch.zeros_like(hist)
    for i in range(2):
        ref = R.lam_image(m, img[i].to(torch.uint8), cls[i])
        assert rel_err(lams[i], ref["lams"]) <= TOL[torch.float32]
        ref_hist += torch.bincount(
            gt[i].flatten() * cfg.num_classes + ref["labels"].flatten(),
            minlength=cfg.num_classes ** 2).reshape(hist.shape)
    assert int(hist.sum()) == 2 * size * size
    assert int((hist - ref_hist).abs().sum()) <= 2 * 0.005 * hist.sum()


def test_text_forward_matches_reference():
    """EVA02-CLIP's text tower is OpenAI's layout with nn.GELU: the
    reference's is openclip.text_forward, act "gelu"."""
    cfg = eva_tiny().clip
    assert R.text_forward is openclip.text_forward
    params = init_clip_params(cfg, torch.Generator().manual_seed(1), "cpu")
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(1, cfg.vocab_size - 1, (3, cfg.context_length),
                           generator=g)
    tokens[:, 9] = cfg.vocab_size - 1
    out = clip_mod.text_forward(params, tokens, cfg)
    for i in range(3):
        ref = R.text_forward(params["text"], tokens[i], cfg.text_heads,
                             act="gelu")
        assert rel_err(out[i], ref) <= TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_swiglu_plain_version_padded_and_not(dtype):
    """`layers.swiglu` on the published hidden (341) and on the served
    one (padded to 344 with zero weights): the same numbers within the
    dtype's tolerance of the reference's SwiGLU, the padded gate's
    columns beyond 341 exactly 0."""
    cfg = eva_tiny(dtype).clip
    params, serve = served(cfg)
    blk, sblk = (t["visual"]["blocks"][1]["mlp"] for t in (params, serve))
    g = torch.Generator().manual_seed(8)
    x = torch.randn((2, 17, 128), generator=g)
    ref = torch.stack([R.swiglu(x[i], blk, R.FP32, 1e-6) for i in range(2)])
    for p in (blk, sblk):
        got = layers.swiglu(x.to(dtype), p)
        assert got.dtype == dtype
        assert rel_err(got, ref) <= TOL[dtype]
    hp = sblk["fc"]["w"].shape[0] // 2
    gate = layers.swiglu_gate(layers._product(x.to(dtype), sblk["fc"]),
                              sblk["fc"]["b"], sblk["ln_ffn"])
    assert gate.shape[-1] == hp and not gate[..., 341:].any()


def test_init_holds_the_swiglu_padded():
    """init_clip_params draws the published hidden (341) and holds it
    padded to 344 as every loader does: W1 and W2 each gain 3 zero rows,
    W3 3 zero columns, the biases zeros there, ln_ffn its 341; padding a
    padded tree returns it as it is."""
    cfg = eva_tiny().clip
    params = init_clip_params(cfg, torch.Generator().manual_seed(4), "cpu")
    m = params["visual"]["blocks"][2]["mlp"]
    assert m["fc"]["w"].shape == (2 * 344, 128)
    assert m["proj"]["w"].shape == (128, 344)
    assert m["ln_ffn"]["scale"].shape == (341,)
    w = m["fc"]["w"].reshape(2, 344, 128)
    assert not w[:, 341:].any() and w[:, :341].abs().min() > 0
    assert not m["fc"]["b"].reshape(2, 344)[:, 341:].any()
    assert not m["proj"]["w"][:, 341:].any()
    assert pad_swiglu(params)["visual"]["blocks"][2]["mlp"] is m
    assert "ln_pre" not in params["visual"]
    assert set(params["visual"]["blocks"][0]["attn"]) == \
        {"qkv", "out", "ln_inner"}


def _eva_state_dict(cfg, params, text_prefix=""):
    """An EVA-CLIP-layout state dict of the port's tree: EVAVisionTransformer
    names under "visual.", separate q / k / v projections with q_bias and
    v_bias, the rotary buffers, OpenAI's text names (under text_prefix)."""
    v = params["visual"]
    width = cfg.vision_width
    sd = {"visual.patch_embed.proj.weight": v["patch_embed"],
          "visual.patch_embed.proj.bias": v["patch_bias"],
          "visual.cls_token": v["class_embedding"].reshape(1, 1, width),
          "visual.pos_embed": v["positional_embedding"][None],
          "visual.norm.weight": v["ln_post"]["scale"],
          "visual.norm.bias": v["ln_post"]["bias"],
          "visual.head.weight": v["proj"].t().contiguous(),
          "visual.head.bias": v["proj_bias"],
          "visual.rope.freqs_cos": torch.zeros(cfg.grid ** 2, 64),
          "visual.rope.freqs_sin": torch.zeros(cfg.grid ** 2, 64)}

    def ln(name, q):
        sd[name + ".weight"], sd[name + ".bias"] = q["scale"], q["bias"]

    h = cfg.hidden
    for i, blk in enumerate(v["blocks"]):
        pre = f"visual.blocks.{i}."
        ln(pre + "norm1", blk["ln_1"])
        ln(pre + "norm2", blk["ln_2"])
        q, k, vv = blk["attn"]["qkv"]["w"].chunk(3)
        qb, _, vb = blk["attn"]["qkv"]["b"].chunk(3)
        sd.update({pre + "attn.q_proj.weight": q, pre + "attn.k_proj.weight":
                   k, pre + "attn.v_proj.weight": vv,
                   pre + "attn.q_bias": qb, pre + "attn.v_bias": vb,
                   pre + "attn.proj.weight": blk["attn"]["out"]["w"],
                   pre + "attn.proj.bias": blk["attn"]["out"]["b"]})
        ln(pre + "attn.inner_attn_ln", blk["attn"]["ln_inner"])
        m = blk["mlp"]
        sd.update({pre + "mlp.w1.weight": m["fc"]["w"][:h],
                   pre + "mlp.w2.weight": m["fc"]["w"][h:],
                   pre + "mlp.w1.bias": m["fc"]["b"][:h],
                   pre + "mlp.w2.bias": m["fc"]["b"][h:],
                   pre + "mlp.w3.weight": m["proj"]["w"],
                   pre + "mlp.w3.bias": m["proj"]["b"]})
        ln(pre + "mlp.ffn_ln", m["ln_ffn"])
    t = params["text"]
    tp = text_prefix
    sd[tp + "token_embedding.weight"] = t["token_embedding"]
    sd[tp + "positional_embedding"] = t["positional_embedding"]
    for i, blk in enumerate(t["blocks"]):
        pre = f"{tp}transformer.resblocks.{i}."
        ln(pre + "ln_1", blk["ln_1"])
        ln(pre + "ln_2", blk["ln_2"])
        for name, q in (("attn.in_proj_", blk["attn"]["qkv"]),
                        ("attn.out_proj.", blk["attn"]["out"]),
                        ("mlp.c_fc.", blk["mlp"]["fc"]),
                        ("mlp.c_proj.", blk["mlp"]["proj"])):
            sd[pre + name + "weight"], sd[pre + name + "bias"] = q["w"], \
                q["b"]
    ln(tp + "ln_final", t["ln_final"])
    sd[tp + "text_projection"] = t["text_projection"]
    sd["logit_scale"] = torch.tensor(4.6052)
    return sd


def _seeded_tree(cfg):
    """The port's init with the EVA tower's drawn parts (k's bias zero)."""
    params = init_clip_params(cfg, torch.Generator().manual_seed(2), "cpu")
    params["visual"] = weights_eva02.clip_visual(cfg, 5, "cpu")["visual"]
    return params


@pytest.mark.parametrize("text_prefix", ["", "text."],
                         ids=["openai_text", "eva_text"])
def test_convert_clip_with_the_eva02_backbone(tmp_path, monkeypatch,
                                              text_prefix):
    """convert_clip --backbone eva02-clip-l-14-336 on an EVA-CLIP-layout
    checkpoint (the name's widths set to the tiny form here, so that the
    checkpoint stays small): the file read back equal to the seeded tree
    (q, k, v fused with k's bias zero, W1|W2 stacked), its config EVA's;
    without the name, or with another, it is refused."""
    from excel_tpu_torch.cli import convert_clip
    from excel_tpu_torch.models.params import load_params_npz

    tiny = eva_tiny().clip
    full = {f.name: getattr(tiny, f.name)
            for f in dataclasses.fields(tiny) if f.name != "compute_dtype"}
    monkeypatch.setitem(C.BACKBONES, EVA, {"full": full, "tiny": {}})
    params = _seeded_tree(tiny)
    sd = _eva_state_dict(tiny, params, text_prefix)
    src, dst = str(tmp_path / "eva.pt"), str(tmp_path / "eva.npz")
    torch.save(sd, src)
    cfg = convert_clip.main(["--backbone", EVA, src, dst])
    assert (cfg.block, cfg.hidden, cfg.rope_grid, cfg.vision_heads) == \
        ("eva02", 341, 16, 2)
    back = load_params_npz(dst, cfg, device="cpu")
    # the file keeps the published hidden; the loader pads it (to 344)
    with np.load(dst) as data:
        assert data["['visual']['blocks'][0]['mlp']['fc']['w']"].shape == \
            (128, 2 * 341)
    assert back["visual"]["blocks"][0]["mlp"]["fc"]["w"].shape == \
        (2 * 344, 128)
    served_tree = pad_swiglu(params)
    for path in (("visual", "patch_bias"), ("visual", "proj_bias"),
                 ("visual", "proj"), ("visual", "positional_embedding"),
                 ("visual", "class_embedding"), ("visual", "patch_embed")):
        a, b = back, params
        for k in path:
            a, b = a[k], b[k]
        assert torch.equal(a, b), path
    for i in (0, 3):
        a, b = back["visual"]["blocks"][i], served_tree["visual"]["blocks"][i]
        for grp, key in (("attn", "qkv"), ("attn", "out"), ("mlp", "fc"),
                         ("mlp", "proj")):
            assert torch.equal(a[grp][key]["w"], b[grp][key]["w"])
            assert torch.equal(a[grp][key]["b"], b[grp][key]["b"])
        for grp, key in (("attn", "ln_inner"), ("mlp", "ln_ffn")):
            assert torch.equal(a[grp][key]["scale"], b[grp][key]["scale"])
        assert not a["attn"]["qkv"]["b"][128:256].any()
    assert torch.equal(back["text"]["blocks"][1]["attn"]["qkv"]["b"],
                       params["text"]["blocks"][1]["attn"]["qkv"]["b"])
    assert "ln_pre" not in back["visual"]
    with pytest.raises(ValueError, match="--backbone"):
        convert_clip.main([src, dst])
    with pytest.raises(ValueError, match="not openclip-vit-h-14"):
        convert_clip.main(["--backbone", "openclip-vit-h-14", src, dst])


def test_backbone_flag_through_infer_lam(tmp_path, monkeypatch):
    """infer_lam --tiny --random-init --backbone eva02-clip-l-14-336 runs
    the sweep through EVA-02's block: heads of 64 with the rotation, the
    SwiGLU at hidden 341 (its plain gate), no ln_pre, at 56 px."""
    from excel_tpu_torch.cli import infer_lam

    seen = {"rope": 0, "hidden": set(), "fc": set(), "size": set(), "ln": 0}
    apply_rope, swiglu = layers.apply_rope, clip_mod.swiglu
    layer_norm = clip_mod.layer_norm_fused

    def spy_rope(t, rope):
        seen["rope"] += 1
        return apply_rope(t, rope)

    def spy_swiglu(x, p, eps=1e-6):
        seen["hidden"].add(p["ln_ffn"]["scale"].shape[0])
        seen["fc"].add(tuple(p["fc"]["w"].shape))
        seen["size"].add(x.shape[1])
        return swiglu(x, p, eps)

    def spy_ln(x, p, eps=1e-5):
        seen["ln"] += 1
        assert eps == 1e-6
        return layer_norm(x, p, eps)

    monkeypatch.setattr(layers, "apply_rope", spy_rope)
    monkeypatch.setattr(clip_mod, "swiglu", spy_swiglu)
    monkeypatch.setattr(clip_mod, "layer_norm_fused", spy_ln)
    scores = infer_lam.main([
        "--device", "cpu", "--tiny", "--random-init", "--synthetic", "4",
        "--training-free", "--backbone", EVA,
        "--work-dir", os.fspath(tmp_path)])
    # 4 blocks, q and k: 8 rotations a batch; block 0's ln_1 and ln_post
    assert seen["rope"] % 8 == 0 and seen["rope"] > 0
    assert seen["hidden"] == {341} and seen["size"] == {4 * 4 + 1}
    # the CLI's weights as its loader holds them: the hidden padded
    assert seen["fc"] == {(2 * 344, 128)}
    assert seen["ln"] % 2 == 0 and seen["ln"] > 0
    assert 0.0 <= scores["miou"] <= 1.0


# the encoder's attention layers as they were before EVA-02's parts came
def _attention_as_it_was(y, p, heads, attn_acc=None, need_weights=True,
                         rope=None, eps=1e-5):
    assert rope is None and "ln_inner" not in p
    q, k, v = layers.qkv_heads_fused(y, p, heads)
    ctx, w = layers.fused_plain_attention(q, k, v, acc=attn_acc,
                                          need_weights=need_weights)
    return layers.linear(layers.merge_heads(ctx), p["out"]), w


def _surgery_as_it_was(y, p, heads, ex_attn=None, attn_acc=None,
                       need_attn=True, rope=None, eps=1e-5):
    assert rope is None and "ln_inner" not in p
    q, k, v = layers.qkv_heads_fused(y, p, heads)
    ex = None
    if ex_attn is not None:
        ex = torch.nn.functional.pad(ex_attn.float(), (1, 0, 1, 0))
    shared, attn_sum, ctx_ori = layers.fused_surgery_attention(
        q, k, v, ex_attn=ex, acc=attn_acc, need_attn=need_attn)
    ctx_dense = torch.matmul(shared[:, None].to(v.dtype), v)
    return (layers.linear(layers.merge_heads(ctx_dense), p["out"]),
            layers.linear(layers.merge_heads(ctx_ori), p["out"]), attn_sum)


@pytest.mark.parametrize("tower", ["openai-vit-b-16", "openclip-vit-h-14"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_other_towers_keep_their_bits(tower, dtype, monkeypatch):
    """The OpenAI default and OpenCLIP ViT-H/14 compute what they computed
    before EVA-02's parts came: their configs leave every new field at its
    neutral value, their trees gain no leaf (init and serving), and their
    tiny towers' outputs equal, bit for bit, those of the attention layers
    as they were (no rotation, no sub-LayerNorm) with the MLP as it was."""
    cfg = with_backbone(tiny_config(), tower, tiny=True)
    cfg = dataclasses.replace(cfg, clip=dataclasses.replace(
        cfg.clip, compute_dtype=dtype)).clip
    assert (cfg.block, cfg.rope_grid, cfg.ln_eps) == ("vit", 0, 1e-5)
    params = W.clip_visual(cfg, 17, "cpu")
    init = init_clip_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert set(init["visual"]) == {"patch_embed", "class_embedding",
                                   "positional_embedding", "ln_pre",
                                   "blocks", "ln_post", "proj"}
    assert set(init["visual"]["blocks"][0]["attn"]) == {"qkv", "out"}
    assert set(init["visual"]["blocks"][0]["mlp"]) == {"fc", "proj"}
    serve = cast_matmul_weights(pad_swiglu(params), dtype)
    assert serve["visual"]["blocks"][0]["mlp"]["fc"]["w"].shape == \
        params["visual"]["blocks"][0]["mlp"]["fc"]["w"].shape
    xs = E.normalize(images(size=cfg.image_size))
    now = clip_mod.vision_forward(serve, xs, cfg, attn_mode="mean")
    monkeypatch.setattr(clip_mod, "attention_fused", _attention_as_it_was)
    monkeypatch.setattr(clip_mod, "surgery_attention_fused",
                        _surgery_as_it_was)
    monkeypatch.setattr(clip_mod, "_block_mlp",
                        lambda h, blk, act, eps=1e-5: layers.mlp(
                            h, blk["mlp"], act))
    before = clip_mod.vision_forward(serve, xs, cfg, attn_mode="mean")
    for key in ("projected", "attn", "feats"):
        assert torch.equal(now[key], before[key])
