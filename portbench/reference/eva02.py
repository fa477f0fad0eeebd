"""EVA02-CLIP's towers: the surgery ViT with EVA-02's block, its
training-free LAM step and the text transformer.

Restates excel_tpu_torch/models/clip.py (`vision_forward` of an EVA-02
tower) and models/layers.py (`rope_table`, `apply_rope`, `context_out`,
`swiglu`) in float32, one image at a time, as encoder.py does for OpenAI's
ViT-B/16; everything else is encoder.py's, pipeline.py's, svc.py's and
par.py's, used as it is.

EVA-02's block (arXiv 2303.11331; EVA-CLIP's EVAVisionTransformer with
EVA02-CLIP-L-14-336.json: rope, pt_hw_seq_len 16, intp_freq, naiveswiglu,
subln, LayerNorm eps 1e-6), x [N, C], tokens 1..N-1 the patches in
row-major order:
  h = LN_1(x); q = h Wq + bq, k = h Wk, v = h Wv + bv (the tree's fused
  qkv, k's bias zero); q and k at the patch tokens turned by the 2D
  rotary table (`rope_table`), the CLS token never;
  x = x + proj(inner_attn_ln(softmax(q k^T / sqrt D) v));
  x = x + w3(ffn_ln(silu(w1 LN_2(x) + b1) * (w2 LN_2(x) + b2))).
Outside the blocks: the patch embedding with its bias, the CLS token and
the positional table, no ln_pre, then norm and head (a Linear with bias).

The SwiGLU's weights are read at their published hidden width h, as
harness/weights_eva02.py draws them: W1 and W2 stacked in `mlp.fc`
[2 h, C] (W1 = rows [0, h), W2 = rows [h, 2 h)), W3 in `mlp.proj`
[C, h]. The program pads its own copy (models/params.pad_swiglu); this
reference is never handed that copy.

Departures from EVA-CLIP's EVAVisionTransformer, each the port's as well:
- the last `surgery` blocks run ExCEL's dual-path attention over the
  rotated q and k and the unrotated v (encoder.surgery_attention's mix of
  q q^T, k k^T and v v^T shared over heads); both contexts, the dense one
  too, run through the block's own inner_attn_ln and proj. EVA-CLIP has
  no dense path, so where its sub-LayerNorm meets the dense context is
  this choice;
- the feature stack, the CLS token from the original path and the
  token-axis L2 norm are encoder.py's quirks;
- every token is projected by norm and head (EVA-CLIP pools the CLS
  token);
- no dropout, drop path or patch dropout, and no xattn: xformers'
  memory-efficient attention computes the same softmax, here formed
  whole;
- the positional table is resized half-pixel bilinear where the grid is
  not the table's (24 x 24 at 336 px: not resized).

`lam_image` is pipeline.lam_image over this encoder, and the names
`cams_from_state`, `label_gap` and `gap_summary` are pipeline.py's, so
that a driver can hand this module to lam_sweep's check in place of
pipeline.py. The text tower is OpenAI's layout with nn.GELU
(openclip.text_forward, act "gelu").
"""
from __future__ import annotations

import torch

from . import encoder as E
from .openclip import text_forward  # noqa: F401
from .pipeline import (cams_from_state, class_ids, gap_summary,  # noqa: F401
                       label_gap, resize, upscale)
from .precision import FP32


def rope_table(grid, head_dim, pt_grid, device=None):
    """(cos, sin) [grid^2, head_dim] of EVA-CLIP's
    VisionRotaryEmbeddingFast(dim=head_dim / 2, pt_seq_len=pt_grid,
    ft_seq_len=grid): for dims [0, D/2) the token's row r, for [D/2, D)
    its column c; pair i of a half at the angle
    (r / grid) pt_grid 10000^(-2i / (D/2)), formed in float32 as it forms
    it."""
    dim = head_dim // 2
    freqs = 1.0 / (10000 ** (torch.arange(0, dim, 2, device=device)
                             [:dim // 2].float() / dim))
    t = torch.arange(grid, device=device) / grid * pt_grid
    f = torch.einsum("i,f->if", t, freqs).repeat_interleave(2, dim=-1)
    f = torch.cat([f[:, None].expand(grid, grid, dim),
                   f[None].expand(grid, grid, dim)], dim=-1)
    f = f.reshape(grid * grid, head_dim)
    return f.cos(), f.sin()


def rotate_half(x):
    """(x0, x1) -> (-x1, x0) over adjacent dims."""
    x1, x2 = x.unflatten(-1, (-1, 2)).unbind(-1)
    return torch.stack((-x2, x1), dim=-1).flatten(-2)


def _qkv(y, p, heads, prec, rope):
    """q, k, v [H, N, D], q and k turned at tokens 1..N-1."""
    q, k, v = E._qkv(y, p, heads, prec)
    cos, sin = rope

    def turn(t):
        body = t[:, 1:]
        return torch.cat([t[:, :1], body * cos + rotate_half(body) * sin],
                         dim=1)

    return turn(q), turn(k), v


def _out(ctx, p, prec, eps):
    """The merged context through inner_attn_ln and proj."""
    return E.linear(E.layer_norm(E._merge(ctx), p["ln_inner"], eps),
                    p["out"], prec)


def plain_attention(y, p, heads, prec, rope, eps):
    """-> (output [N, C], head-mean weights [N, N])."""
    q, k, v = _qkv(y, p, heads, prec, rope)
    attn = E._softmax_sim(q, k, prec)
    return _out(prec.mm(attn, v), p, prec, eps), attn.mean(0)


def surgery_attention(y, p, heads, prec, rope, eps, ex_attn=None):
    """-> (dense output, original output, head-summed original weights)."""
    q, k, v = _qkv(y, p, heads, prec, rope)
    attn_ori = E._softmax_sim(q, k, prec)
    mix = (E._softmax_sim(q, q, prec) + E._softmax_sim(k, k, prec)
           + E._softmax_sim(v, v, prec)) / 3.0
    if ex_attn is not None:
        mix = mix.clone()
        mix[:, 1:, 1:] += ex_attn[None]
    shared = mix.sum(0)
    dense = _out(prec.mm(shared[None], v), p, prec, eps)
    ori = _out(prec.mm(attn_ori, v), p, prec, eps)
    return dense, ori, attn_ori.sum(0)


def swiglu(x, p, prec, eps):
    """w3(ffn_ln(silu(w1 x + b1) * (w2 x + b2))) at the hidden width h of
    ffn_ln."""
    h = p["ln_ffn"]["scale"].shape[0]
    w, b = p["fc"]["w"].float(), p["fc"]["b"].float()
    a = prec.mm(x, w[:h].t()) + b[:h]
    g = prec.mm(x, w[h:].t()) + b[h:]
    m = E.layer_norm(torch.nn.functional.silu(a) * g, p["ln_ffn"], eps)
    return prec.mm(m, p["proj"]["w"].float().t()) + p["proj"]["b"].float()


def vision_forward(visual, image, heads, surgery, window, prec=FP32,
                   rope_grid=16, eps=1e-6, ex_attn=None, need_attn=True,
                   stack=False):
    """encoder.vision_forward over EVA-02's blocks: one normalised image
    [H, W, 3] -> {"projected" [N, E], "attn" [N, N] or None, "feats"
    [L, N, width]} (and "stack" [window, N, N] with stack)."""
    w = visual["patch_embed"].float()
    width, _, ps, _ = w.shape
    h, wd, _ = image.shape
    gh, gw = h // ps, wd // ps
    if gh != gw:
        raise NotImplementedError("the cells' images are square")
    patches = image[:gh * ps, :gw * ps].reshape(gh, ps, gw, ps, 3)
    patches = patches.permute(0, 2, 4, 1, 3).reshape(gh * gw, 3 * ps * ps)
    x = prec.mm(patches, w.reshape(width, -1).t()) \
        + visual["patch_bias"].float()
    x = torch.cat([visual["class_embedding"].float()[None], x])
    x = x + E.pos_embedding(visual["positional_embedding"], gh)
    rope = rope_table(gh, width // heads, rope_grid, x.device)
    blocks = visual["blocks"]
    n_single = len(blocks) - surgery
    acc = None
    per_block = []
    single, ori_feats, ori_res = [], [], []
    x_ori = None
    for i, blk in enumerate(blocks):
        if i < n_single:
            y, wts = plain_attention(E.layer_norm(x, blk["ln_1"], eps),
                                     blk["attn"], heads, prec, rope, eps)
            x = x + y
            x = x + swiglu(E.layer_norm(x, blk["ln_2"], eps), blk["mlp"],
                           prec, eps)
            single.append(x)
        else:
            src = x if x_ori is None else x_ori
            dense, ori, wts = surgery_attention(
                E.layer_norm(src, blk["ln_1"], eps), blk["attn"], heads,
                prec, rope, eps, ex_attn)
            x_ori = src + ori
            x_ori = x_ori + swiglu(E.layer_norm(x_ori, blk["ln_2"], eps),
                                   blk["mlp"], prec, eps)
            x = x + dense
            ori_feats.append(x_ori)
            ori_res.append(ori)
        if need_attn and i >= len(blocks) - window:
            acc = wts if acc is None else acc + wts
            per_block.append(wts)
    if x_ori is not None:
        x = torch.cat([x_ori[:1], x[1:]])
    feats = single[:-1] + [x]
    feats += [ori_feats[j] + ori_res[j + 1] for j in range(len(ori_feats) - 1)]
    feats.append(ori_feats[-1])
    x = E.layer_norm(x, visual["ln_post"], eps)
    projected = prec.mm(x, visual["proj"].float()) \
        + visual["proj_bias"].float()
    projected = projected / projected.norm(dim=0, keepdim=True)
    out = {"projected": projected,
           "attn": acc / window if need_attn else None,
           "feats": torch.stack(feats)}
    if stack:
        out["stack"] = torch.stack(per_block)
    return out


def lam_image(m, raw, cls, prec=FP32):
    """pipeline.lam_image over this encoder (m["rope_grid"], m["eps"]):
    raw [h, w, 3] uint8, cls [num_fg] {0, 1} -> {"lams", "attn", "cams",
    "labels", "guide"}."""
    h, w = raw.shape[:2]
    x = E.normalize(resize(raw, m["size"]))
    out = vision_forward(m["visual"], x, m["heads"], m["surgery"],
                         m["window"], prec, m["rope_grid"], m["eps"])
    lam = E.lams(out["projected"], m["text"], m["num_fg"])
    present = torch.nonzero(cls > 0).flatten()
    guide = upscale(x.permute(2, 0, 1), (h, w), align=True)
    cams = cams_from_state(m, lam[:, present].t(), out["attn"][1:, 1:],
                           guide, prec)
    return {"lams": lam, "attn": out["attn"], "cams": cams,
            "labels": class_ids(present)[cams.argmax(dim=0)],
            "guide": guide}
