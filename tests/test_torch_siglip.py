"""SigLIP So400m/14-384 as the port's backbone, on the CPU: the port's towers
against the benchmark's plain float32 reference (portbench/reference/
siglip.py) at a small SigLIP-shaped size (width 144 in 2 heads of 72, MLP
hidden 536, a multiple of 8 other than 4 x 144, patch 14, grid 4: 56 px;
no CLS token, the attention-pooling head, tanh GELU, eps 1e-6, mean and
std 0.5) on seeded random weights; each of SigLIP's parts seen by the
comparison; MSC's positional table without a CLS row and the head over
729-row features; a train step; the named backbone through config
inference, the converter and a CLI; and the OpenAI default bit for bit as
it was.

Tolerances (relative to the largest magnitude of the compared output):
- float32, 1e-5: the same arithmetic summed in another order (the port
  batches images and heads, the reference takes one image and per-head
  products); the readings are below 1e-6;
- bfloat16, 0.03: the port rounds every product and the residual stream
  to bfloat16 (2^-8 = 0.0039 a rounding) through 4 blocks and the head;
  the readings are below 0.018.
The float32 comparison is the one that holds SigLIP's parts: dropping any
one of them moves the output by more than 10 times the float32 tolerance
(test_the_comparison_sees_each_part). The bfloat16 one cannot see all of
them: tanh GELU and exact GELU differ by less than a bf16 rounding over
most of their range.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from excel_tpu_torch import config as C
from excel_tpu_torch.config import tiny_config, with_backbone
from excel_tpu_torch.engine import evaluate
from excel_tpu_torch.engine.pipeline import normalize_images
from excel_tpu_torch.models import clip as clip_mod
from excel_tpu_torch.models import layers
from excel_tpu_torch.models.excel import compute_lams
from excel_tpu_torch.models.params import (cast_matmul_weights,
                                           init_clip_params)
from portbench.harness import weights as W
from portbench.harness import weights_siglip
from portbench.reference import head as RH
from portbench.reference import siglip as R

torch.set_num_threads(1)

SIGLIP = "siglip-so400m-14-384"
TOL = {torch.float32: 1e-5, torch.bfloat16: 0.03}


def sig_tiny(dtype=torch.float32, **clip):
    cfg = with_backbone(tiny_config(), SIGLIP, tiny=True)
    return dataclasses.replace(cfg, clip=dataclasses.replace(
        cfg.clip, compute_dtype=dtype, **clip))


def served(cfg, seed=11):
    """(the seeded tree, as the port serves it: the matmul weights in the
    compute type)."""
    params = weights_siglip.clip_visual(
        dataclasses.replace(cfg, compute_dtype=torch.float32), seed, "cpu")
    serve = params
    if cfg.compute_dtype == torch.bfloat16:
        serve = cast_matmul_weights(params, torch.bfloat16)
    return params, serve


def rel_err(got, ref) -> float:
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max())


def images(b=2, size=56, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (b, size, size, 3), generator=g).float()


def reference(params, x, cfg, **kw):
    return R.vision_forward(params["visual"], x, cfg.vision_heads,
                            cfg.surgery_blocks, cfg.attn_out_layers,
                            eps=cfg.ln_eps, stack=kw.get("need_attn", True),
                            **kw)


def test_presets_are_siglip_shaped():
    c = sig_tiny().clip
    assert (c.vision_width // c.vision_heads, c.patch_size, c.grid, c.tokens,
            c.hidden, c.block, c.ln_eps, c.patch_start, c.tokenizer,
            c.activation, c.image_stats) == \
        (72, 14, 4, 16, 536, "siglip", 1e-6, 0, "siglip", "gelu_tanh",
         ((127.5,) * 3, (127.5,) * 3))
    assert c.hidden % 8 == 0 and c.hidden != 4 * c.vision_width
    full = with_backbone(C.fast(C.voc_config()), SIGLIP)
    assert (full.clip.vision_width, full.clip.vision_heads,
            full.clip.vision_layers, full.clip.grid, full.clip.tokens,
            full.clip.hidden, full.clip.embed_dim, full.clip.pretrain_grid,
            full.clip.text_width, full.clip.text_layers,
            full.clip.context_length, full.clip.vocab_size,
            full.clip.compute_dtype) == \
        (1152, 16, 27, 27, 729, 4304, 1152, 27, 1152, 27, 64, 32000,
         torch.bfloat16)
    assert (full.head.in_channels, full.head.num_blocks,
            full.data.crop_size) == (1152, 27, 378)
    default = C.ClipConfig()
    assert (default.patch_start, default.tokens, default.image_stats,
            default.text_causal, default.text_pool, default.text_ln_eps,
            default.text_mlp_hidden, default.tokenizer) == \
        (1, 401, C.IMAGENET_STATS, True, "eot", 1e-5, 0, "clip")


@pytest.mark.parametrize("attn_mode", ["stack", "mean", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_vision_forward_matches_reference(dtype, attn_mode):
    cfg = sig_tiny(dtype).clip
    params, serve = served(cfg)
    x = normalize_images(images(), cfg.image_stats)
    out = clip_mod.vision_forward(serve, x, cfg, attn_mode=attn_mode)
    assert out["projected"].shape == (2, 17, 144)
    assert out["feats"].shape == (4, 2, 16, 144)
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


def test_calibrated_pass_matches_reference():
    """The LVC-calibrated pass (ex_feats on the 4 x 4 grid): the feature
    affinity reaches every token's mix, there being no CLS row to skip."""
    cfg = sig_tiny().clip
    params, serve = served(cfg)
    x = normalize_images(images(), cfg.image_stats)
    g = torch.Generator().manual_seed(4)
    ex_feats = torch.randn((2, 32, 4, 4), generator=g)
    out = clip_mod.vision_forward(serve, x, cfg, ex_feats=ex_feats,
                                  attn_mode="none")
    ex = layers.external_feature_attention(ex_feats)
    assert ex.shape == (2, 16, 16)
    for i in range(2):
        ref = reference(params, x[i], cfg, ex_attn=ex[i], need_attn=False)
        proj = out["projected"][i]
        assert rel_err(proj / proj.norm(dim=0, keepdim=True),
                       ref["projected"]) <= TOL[torch.float32]
        assert rel_err(out["feats"][:, i], ref["feats"]) \
            <= TOL[torch.float32]


def _exact_gelu(x):
    return torch.nn.functional.gelu(x)


def _map_head_mean_pool(q, k, v, mask=None):
    """The pooled row as a plain mean of the values."""
    return v.mean(dim=2, keepdim=True).expand(-1, -1, q.shape[2], -1), None


def _map_head_without_residual(p, x_ori, x_dense, heads, act, eps):
    h = p["map_head"]
    c = x_dense.shape[-1]
    w, bias = h["attn"]["qkv"]["w"], h["attn"]["qkv"]["b"]
    post_ori = layers.layer_norm(x_ori, p["ln_post"], eps)
    post_dense = layers.layer_norm(x_dense, p["ln_post"], eps)
    q = layers.linear(h["probe"][None], {"w": w[:c], "b": bias[:c]})
    k, v = layers.linear(post_ori, {"w": w[c:], "b": bias[c:]}).chunk(2, -1)
    pooled, _ = layers.attend(*(layers.split_heads(t, heads)
                                for t in (q, k, v)))
    v_dense = layers.linear(post_dense, {"w": w[2 * c:], "b": bias[2 * c:]})
    e = layers.linear(torch.cat([layers.merge_heads(pooled), v_dense], 1),
                      h["attn"]["out"])
    return clip_mod.mlp(layers.layer_norm(e, h["ln"], eps), h["mlp"], act)


PARTS = {
    "gelu_tanh": dict(patch=(layers.ACTIVATIONS, "gelu_tanh", _exact_gelu)),
    "pooled_row": dict(patch=(clip_mod, "attend", _map_head_mean_pool)),
    "head_residual": dict(patch=(clip_mod, "map_head",
                                 _map_head_without_residual)),
    "eps_1e-5": dict(cfg=dict(ln_eps=1e-5)),
    "image_stats": dict(stats=C.IMAGENET_STATS),
}


@pytest.mark.parametrize("part", sorted(PARTS) + ["causal_text"])
def test_the_comparison_sees_each_part(part, monkeypatch):
    """The port's fp32 tower with one of SigLIP's parts replaced (tanh
    GELU by exact GELU, the pooled row by a mean of the values, the head's
    MLP without its residual, eps 1e-5 for 1e-6, ImageNet's statistics
    for 0.5 / 0.5; in the text tower a causal mask) against the full
    reference misses the float32 tolerance by more than 10 times, in
    `projected` or the feature stack (the text embedding)."""
    if part == "causal_text":
        cfg = sig_tiny(text_causal=True).clip
        params = init_clip_params(cfg, torch.Generator().manual_seed(1),
                                  "cpu")
        g = torch.Generator().manual_seed(0)
        tokens = torch.randint(1, cfg.vocab_size, (1, cfg.context_length),
                               generator=g)
        ref = R.text_forward(params["text"], tokens[0], cfg.text_heads)
        err = rel_err(clip_mod.text_forward(params, tokens, cfg)[0], ref)
        assert err > 10 * TOL[torch.float32], err
        return
    spec = PARTS[part]
    full = sig_tiny().clip
    cfg = sig_tiny(**spec.get("cfg", {})).clip
    params, _ = served(full)
    if "patch" in spec:
        monkeypatch.setitem(*spec["patch"]) \
            if isinstance(spec["patch"][0], dict) \
            else monkeypatch.setattr(*spec["patch"])
    img = images(b=1)
    x = normalize_images(img, spec.get("stats", cfg.image_stats))
    out = clip_mod.vision_forward(params, x, cfg, attn_mode="none")
    ref = reference(params, R.normalize(img[0]), full, need_attn=False)
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
            "iters": cfg.refine.par_iters, "eps": cfg.clip.ln_eps}


@pytest.mark.parametrize("size", [56, 378], ids=["grid4", "grid27"])
def test_lams_and_hist_step_match_reference(size):
    """compute_lams and one training-free lam_eval_hist_step, at grid 4 and
    at So400m/14's grid 27 (378 px, 729 tokens: the positional table
    resized from 4 with no CLS row): the LAMs within the float32
    tolerance, the hist within two pixels a differing label of the one
    from the reference's labels."""
    cfg = sig_tiny(image_size=size)
    params, serve = served(cfg.clip)
    text = W.text_bank(cfg.num_fg + 3, cfg.clip.embed_dim, 11, "cpu")
    img = images(size=size, seed=5)
    cls = torch.zeros(2, cfg.num_fg)
    cls[0, 1] = cls[1, 3] = cls[1, 4] = 1.0
    g = torch.Generator().manual_seed(6)
    gt = torch.randint(0, cfg.num_classes, (2, size, size), generator=g)
    valid = torch.tensor([[size, size]] * 2)
    out = clip_mod.encode_image(
        serve, normalize_images(img, cfg.clip.image_stats), cfg.clip,
        attn_mode="mean")
    lams = compute_lams(out, text, cfg.num_fg)
    assert lams.shape == (2, (size // 14) ** 2, cfg.num_fg)
    hist = evaluate.lam_eval_hist_step(
        torch.zeros((cfg.num_classes,) * 2, dtype=torch.int64),
        {"clip": serve}, img, cls, gt, valid, text, cfg, (size, size))
    m = _reference_numbers(cfg, params, text)
    ref_hist = torch.zeros_like(hist)
    for i in range(2):
        ref = R.lam_image(m, img[i].to(torch.uint8), cls[i])
        assert rel_err(lams[i], ref["lams"]) <= TOL[torch.float32]
        assert rel_err(out["attn"][i], ref["attn"]) <= TOL[torch.float32]
        ref_hist += torch.bincount(
            gt[i].flatten() * cfg.num_classes + ref["labels"].flatten(),
            minlength=cfg.num_classes ** 2).reshape(hist.shape)
    assert int(hist.sum()) == 2 * size * size
    assert int((hist - ref_hist).abs().sum()) <= 2 * 0.005 * hist.sum()


def test_text_forward_matches_reference():
    """SigLIP's text tower: no mask, the last position, LN eps 1e-6, the
    head's bias; MLP hidden text_mlp_hidden (88 in the tiny form)."""
    cfg = sig_tiny().clip
    params = init_clip_params(cfg, torch.Generator().manual_seed(1), "cpu")
    t = params["text"]
    t["text_projection_bias"] = 0.1 * torch.randn(
        cfg.embed_dim, generator=torch.Generator().manual_seed(2))
    assert t["blocks"][0]["mlp"]["fc"]["w"].shape == (88, 32)
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(1, cfg.vocab_size, (3, cfg.context_length),
                           generator=g)
    out = clip_mod.text_forward(params, tokens, cfg)
    assert out.shape == (3, cfg.embed_dim)
    for i in range(3):
        ref = R.text_forward(t, tokens[i], cfg.text_heads)
        assert rel_err(out[i], ref) <= TOL[torch.float32]


@pytest.mark.parametrize("side", [2, 3, 5, 6, 8])
def test_positional_table_without_a_cls_row_resizes_as_its_grid(side):
    """MSC's grids: a table with no CLS row resizes exactly as the grid
    part of one with a CLS row (antialiased below the table's 4 x 4)."""
    g = torch.Generator().manual_seed(side)
    pos = torch.randn((16, 144), generator=g)
    with_cls = torch.cat([torch.randn((1, 144), generator=g), pos])
    got = clip_mod.interpolate_pos_embedding(pos, side, cls_token=False)
    want = clip_mod.interpolate_pos_embedding(with_cls, side)
    assert got.shape == (side * side, 144)
    assert torch.equal(got, want[1:])


def _head(cfg):
    from excel_tpu_torch.models.head import LvcHead

    state = W.head_state(cfg.head, cfg.num_classes, 3, "cpu")
    head = LvcHead(cfg.head, cfg.num_classes)
    head.load_state_dict(state)
    return head, state


@pytest.mark.parametrize("size", [56, 84, 112])
def test_msc_scales_run_the_head_over_every_token(size):
    """The seg branch at MSC's scales (grids 4, 6 and 8): the head reads
    every one of the grid's tokens (no CLS row to drop), its logits those
    of the reference's head over the reference tower's feature stack."""
    cfg = sig_tiny()
    params, _ = served(cfg.clip)
    head, state = _head(cfg)
    text = W.text_bank(cfg.num_fg + 3, cfg.clip.embed_dim, 11, "cpu")
    img = images(b=2, size=size, seed=9)
    logits = evaluate.seg_grid_logits(
        {"clip": params, "head": head}, img, text,
        dataclasses.replace(cfg, clip=dataclasses.replace(
            cfg.clip, image_size=size)))
    g = size // 14
    assert logits.shape == (2, cfg.num_classes, g, g)
    for i in range(2):
        ref = reference(params, R.normalize(img[i]), cfg.clip,
                        need_attn=False)
        fused = RH.fuse(state, ref["feats"], cfg.head.num_blocks)
        want, _ = RH.decoder(state, fused, cfg.head.decoder_layers,
                             cfg.head.decoder_heads)
        assert rel_err(logits[i], want.t().reshape(-1, g, g)) <= 1e-4


def test_msc_hist_step_at_every_scale():
    """One MSC batch at the scales 1.0, 0.7 and 1.5 (grids 4, 2 and 6: the
    table shrunk with antialiasing and grown) with flips: every pixel
    counted once."""
    cfg = sig_tiny()
    params, _ = served(cfg.clip)
    head, _ = _head(cfg)
    text = W.text_bank(cfg.num_fg + 3, cfg.clip.embed_dim, 11, "cpu")
    scales = (1.0, 0.7, 1.5)
    cfgs = evaluate._scale_cfgs(cfg, 56, scales)
    imgs = tuple(images(b=2, size=int(56 * s), seed=2) for s in scales)
    gt = torch.zeros((2, 40, 50), dtype=torch.int64)
    hist = evaluate.msc_hist_step(
        torch.zeros((cfg.num_classes,) * 2, dtype=torch.int64),
        {"clip": params, "head": head}, imgs, gt,
        torch.tensor([[40, 50]] * 2), text, cfgs, (40, 50),
        (False, True, True))
    assert int(hist.sum()) == 2 * 40 * 50


def test_train_step_over_the_siglip_tower():
    """Three train steps on the tiny SigLIP config, one in each phase
    (LAMs from the encoder's block mean; calibrated; seg affinity): finite
    losses, the head moved, the encoder's weights not."""
    from excel_tpu_torch.engine.train import init_train_state, train_step

    cfg = sig_tiny()
    params, _ = served(cfg.clip)
    before = params["visual"]["blocks"][1]["mlp"]["fc"]["w"].clone()
    head, _ = _head(cfg)
    w0 = next(head.parameters()).detach().clone()
    state = init_train_state(head, cfg.train)
    text = W.text_bank(cfg.num_fg + 3, cfg.clip.embed_dim, 11, "cpu")
    img = images(b=2, size=56, seed=7).to(torch.uint8)
    cls = torch.zeros(2, cfg.num_fg)
    cls[0, 0] = cls[1, 2] = 1.0
    for calibrated, seg_aff in ((False, False), (True, False), (True, True)):
        state, m = train_step(state, params, img, cls, text, None, cfg,
                              calibrated=calibrated, seg_affinity=seg_aff)
        for key in ("loss", "seg_loss", "diver_loss"):
            assert torch.isfinite(m[key]), key
    assert not torch.equal(next(head.parameters()).detach(), w0)
    assert torch.equal(params["visual"]["blocks"][1]["mlp"]["fc"]["w"],
                       before)


def _siglip_state_dict(cfg, params):
    """transformers' SiglipModel names of the port's tree: separate q / k /
    v projections, the head's fused in_proj, the text head's weight."""
    sd = {}
    v, t = params["visual"], params["text"]

    def ln(name, q):
        sd[name + ".weight"], sd[name + ".bias"] = q["scale"], q["bias"]

    def lin(name, q):
        sd[name + ".weight"], sd[name + ".bias"] = q["w"], q["b"]

    def layer(pre, blk):
        ln(pre + "layer_norm1", blk["ln_1"])
        ln(pre + "layer_norm2", blk["ln_2"])
        ws = blk["attn"]["qkv"]["w"].chunk(3)
        bs = blk["attn"]["qkv"]["b"].chunk(3)
        for n, w, b in zip("qkv", ws, bs):
            lin(pre + f"self_attn.{n}_proj", {"w": w, "b": b})
        lin(pre + "self_attn.out_proj", blk["attn"]["out"])
        lin(pre + "mlp.fc1", blk["mlp"]["fc"])
        lin(pre + "mlp.fc2", blk["mlp"]["proj"])

    vm = "vision_model."
    sd[vm + "embeddings.patch_embedding.weight"] = v["patch_embed"]
    sd[vm + "embeddings.patch_embedding.bias"] = v["patch_bias"]
    sd[vm + "embeddings.position_embedding.weight"] = \
        v["positional_embedding"]
    for i, blk in enumerate(v["blocks"]):
        layer(f"{vm}encoder.layers.{i}.", blk)
    ln(vm + "post_layernorm", v["ln_post"])
    h = v["map_head"]
    sd[vm + "head.probe"] = h["probe"][None]
    sd[vm + "head.attention.in_proj_weight"] = h["attn"]["qkv"]["w"]
    sd[vm + "head.attention.in_proj_bias"] = h["attn"]["qkv"]["b"]
    lin(vm + "head.attention.out_proj", h["attn"]["out"])
    ln(vm + "head.layernorm", h["ln"])
    lin(vm + "head.mlp.fc1", h["mlp"]["fc"])
    lin(vm + "head.mlp.fc2", h["mlp"]["proj"])
    tm = "text_model."
    sd[tm + "embeddings.token_embedding.weight"] = t["token_embedding"]
    sd[tm + "embeddings.position_embedding.weight"] = \
        t["positional_embedding"]
    for i, blk in enumerate(t["blocks"]):
        layer(f"{tm}encoder.layers.{i}.", blk)
    ln(tm + "final_layer_norm", t["ln_final"])
    sd[tm + "head.weight"] = t["text_projection"].t().contiguous()
    sd[tm + "head.bias"] = t["text_projection_bias"]
    sd["logit_scale"] = torch.tensor([4.6052])
    sd["logit_bias"] = torch.tensor([-10.0])
    return sd


def _seeded_tree(cfg):
    params = init_clip_params(cfg, torch.Generator().manual_seed(2), "cpu")
    params["visual"] = weights_siglip.clip_visual(cfg, 5, "cpu")["visual"]
    params["text"]["text_projection_bias"] = torch.randn(
        cfg.embed_dim, generator=torch.Generator().manual_seed(3))
    return params


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_convert_clip_with_the_siglip_backbone(tmp_path, monkeypatch):
    """convert_clip --backbone siglip-so400m-14-384 on a transformers-layout
    checkpoint (the name's widths set to the tiny form here, so that the
    checkpoint stays small): the file read back equal, leaf for leaf, to
    the seeded tree (q, k, v fused, the head's in_proj as it is, the text
    head transposed with its bias), its config SigLIP's; without the name,
    or with another, it is refused."""
    from excel_tpu_torch.cli import convert_clip
    from excel_tpu_torch.models.params import load_params_npz

    tiny = sig_tiny().clip
    full = {f.name: getattr(tiny, f.name)
            for f in dataclasses.fields(tiny) if f.name != "compute_dtype"}
    monkeypatch.setitem(C.BACKBONES, SIGLIP, {"full": full, "tiny": {}})
    params = _seeded_tree(tiny)
    src, dst = str(tmp_path / "siglip.bin"), str(tmp_path / "siglip.npz")
    torch.save(_siglip_state_dict(tiny, params), src)
    cfg = convert_clip.main(["--backbone", SIGLIP, src, dst])
    assert (cfg.block, cfg.hidden, cfg.vision_heads, cfg.patch_start,
            cfg.tokenizer) == ("siglip", 536, 2, 0, "siglip")
    back = load_params_npz(dst, cfg, device="cpu")
    want = dict(_leaves({k: params[k] for k in ("visual", "text")}))
    got = dict(_leaves({k: back[k] for k in ("visual", "text")}))
    assert set(got) == set(want)
    for path, value in want.items():
        assert torch.equal(got[path].float(), value.float()), path
    with pytest.raises(ValueError, match="--backbone"):
        convert_clip.main([src, dst])
    with pytest.raises(ValueError, match="not openclip-vit-h-14"):
        convert_clip.main(["--backbone", "openclip-vit-h-14", src, dst])


def test_backbone_flag_through_infer_lam(tmp_path, monkeypatch):
    """infer_lam --tiny --random-init --backbone siglip-so400m-14-384 runs
    the sweep through SigLIP's tower: 16 tokens of 144 (no CLS) in heads
    of 72, tanh GELU, the attention-pooling head, images normalised with
    0.5 / 0.5; its prompts cannot be tokenized (no SentencePiece model in
    the repository), and the text bank and the bank tool say so."""
    from excel_tpu_torch.cli import infer_lam
    from excel_tpu_torch.engine import pipeline

    seen = {"heads": set(), "act": set(), "head": 0, "stats": set()}
    attention, head, fc_act = (clip_mod.attention_fused, clip_mod.map_head,
                               clip_mod.fc_act_fused)
    normalize = evaluate.normalize_images

    def spy_attention(y, p, heads, **kw):
        seen["heads"].add((y.shape[1], y.shape[2] // heads))
        return attention(y, p, heads, **kw)

    def spy_head(*args):
        seen["head"] += 1
        return head(*args)

    def spy_fc_act(u, bias, act):
        seen["act"].add(act)
        return fc_act(u, bias, act)

    def spy_normalize(x, stats=pipeline.IMAGENET_STATS):
        seen["stats"].add(stats)
        return normalize(x, stats)

    monkeypatch.setattr(clip_mod, "attention_fused", spy_attention)
    monkeypatch.setattr(clip_mod, "map_head", spy_head)
    monkeypatch.setattr(clip_mod, "fc_act_fused", spy_fc_act)
    monkeypatch.setattr(evaluate, "normalize_images", spy_normalize)
    argv = ["--device", "cpu", "--tiny", "--synthetic", "4",
            "--training-free", "--backbone", SIGLIP,
            "--work-dir", os.fspath(tmp_path)]
    scores = infer_lam.main(argv + ["--random-init"])
    assert seen["heads"] == {(16, 72)}
    assert seen["act"] == {"gelu_tanh"} and seen["head"] > 0
    assert seen["stats"] == {C.SIGLIP_STATS}
    assert 0.0 <= scores["miou"] <= 1.0
    from excel_tpu_torch.models.excel import build_text_bank

    params = init_clip_params(sig_tiny().clip, None, "cpu")
    with pytest.raises(NotImplementedError, match="spiece.model"):
        build_text_bank(params, sig_tiny(), ["cat"], torch.zeros(144, 4))
    from excel_tpu_torch.cli import make_attr_bank

    with pytest.raises(NotImplementedError, match="spiece.model"):
        make_attr_bank.main(["--device", "cpu", "--tiny", "--random-init",
                             "--backbone", SIGLIP,
                             "--out", os.fspath(tmp_path / "bank.npz")])


# the encoder's pieces as they were before SigLIP's parts came
def _interpolate_as_it_was(pos, new_side, cls_token=True):
    assert cls_token
    cls_tok, grid = pos[:1], pos[1:]
    side = int(round(float(grid.shape[0]) ** 0.5))
    c = grid.shape[-1]
    if side == new_side:
        return pos
    grid = grid.reshape(side, side, c).permute(2, 0, 1)[None]
    scale = torch.full((1, 2), new_side / side, dtype=torch.float32)
    grid = clip_mod.scale_and_translate(grid, (new_side, new_side), scale,
                                        torch.zeros_like(scale),
                                        antialias=True)
    return torch.cat([cls_tok, grid[0].permute(1, 2, 0).reshape(-1, c)],
                     dim=0)


def _surgery_as_it_was(y, p, heads, ex_attn=None, attn_acc=None,
                       need_attn=True, rope=None, eps=1e-5):
    q, k, v = layers.qkv_heads_fused(y, p, heads, rope)
    ex = None
    if ex_attn is not None:
        ex = torch.nn.functional.pad(ex_attn.float(), (1, 0, 1, 0))
    shared, attn_sum, ctx_ori = layers.fused_surgery_attention(
        q, k, v, ex_attn=ex, acc=attn_acc, need_attn=need_attn)
    ctx_dense = torch.matmul(shared[:, None].to(v.dtype), v)
    return (layers.context_out(ctx_dense, p, eps),
            layers.context_out(ctx_ori, p, eps), attn_sum)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("size", [64, 48], ids=["grid4", "grid3"])
def test_openai_default_keeps_its_bits(dtype, size, monkeypatch):
    """The OpenAI default computes what it computed before SigLIP's parts
    came: its config leaves every new field at its neutral value, its tree
    gains no leaf, ImageNet's statistics normalise as they did, and its
    tiny tower's outputs (a calibrated pass too, and a resized table)
    equal, bit for bit, those of the pieces as they were; SVC's default
    patch rows are those after the CLS row."""
    from excel_tpu_torch.ops.affinity import refine_lams_batch

    cfg = dataclasses.replace(tiny_config().clip, compute_dtype=dtype)
    assert (cfg.patch_start, cfg.tokenizer, cfg.image_stats) == \
        (1, "clip", C.IMAGENET_STATS)
    init = init_clip_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert set(init["visual"]) == {"patch_embed", "class_embedding",
                                   "positional_embedding", "ln_pre",
                                   "blocks", "ln_post", "proj"}
    assert "text_projection_bias" not in init["text"]
    params = W.clip_visual(cfg, 17, "cpu")
    img = images(size=size)
    x = normalize_images(img)
    mean = torch.tensor(C.IMAGENET_STATS[0])
    std = torch.tensor(C.IMAGENET_STATS[1])
    assert torch.equal(x, (img - mean) * (1.0 / std))
    ex_feats = torch.randn((2, 32, size // 16, size // 16),
                           generator=torch.Generator().manual_seed(1))
    outs = [clip_mod.vision_forward(params, x, cfg, attn_mode="mean"),
            clip_mod.vision_forward(params, x, cfg, ex_feats=ex_feats,
                                    attn_mode="none")]
    monkeypatch.setattr(clip_mod, "interpolate_pos_embedding",
                        _interpolate_as_it_was)
    monkeypatch.setattr(clip_mod, "surgery_attention_fused",
                        _surgery_as_it_was)
    before = [clip_mod.vision_forward(params, x, cfg, attn_mode="mean"),
              clip_mod.vision_forward(params, x, cfg, ex_feats=ex_feats,
                                      attn_mode="none")]
    for now, was in zip(outs, before):
        for key in ("projected", "attn", "feats"):
            if was[key] is None:
                assert now[key] is None
            else:
                assert torch.equal(now[key], was[key]), key
    hw = (size // 16) ** 2
    lams = torch.rand((2, 3, hw), generator=torch.Generator().manual_seed(2))
    attn = outs[0]["attn"]
    assert torch.equal(
        refine_lams_batch(lams, attn, 0.75, (size // 16,) * 2),
        refine_lams_batch(lams, attn, 0.75, (size // 16,) * 2,
                          patch_start=1))
    assert np.isfinite(refine_lams_batch(lams, attn, 0.75,
                                         (size // 16,) * 2).numpy()).all()
