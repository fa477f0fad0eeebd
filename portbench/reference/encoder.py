"""The surgery ViT-B/16 encoder, its LAMs and the LVC feature calibration.

Restates excel_tpu_torch/models/clip.py (`vision_forward`,
`encode_image`), models/layers.py (LayerNorm, QuickGELU, plain and surgery
attention, `external_feature_attention`), ops/surgery.py
(`clip_feature_surgery`) and models/excel.py (`compute_lams`) in float32,
one image at a time. The quirks kept: the last `surgery` blocks run the
dual-path attention (original q k^T path and the dense mix of q q^T, k k^T
and v v^T shared over heads), the CLS token comes from the original path,
the feature stack repeats the reference's aliased views, and the encoder's
output is L2-normalised over the token axis.

Weights are the parameter tree the benchmark made (`harness/weights.py`):
linear weights [out, in], the patch embedding [width, 3, P, P].
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import FP32, Precision


def layer_norm(x, p, eps=1e-5):
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"].float() \
        + p["bias"].float()


def linear(x, p, prec: Precision):
    out = prec.mm(x, p["w"].float().t())
    return out + p["b"].float() if "b" in p else out


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def mlp(x, p, prec):
    return linear(quick_gelu(linear(x, p["fc"], prec)), p["proj"], prec)


def _heads(x, heads):
    n, c = x.shape
    return x.reshape(n, heads, c // heads).transpose(0, 1)   # [H, N, D]


def _merge(x):
    h, n, d = x.shape
    return x.transpose(0, 1).reshape(n, h * d)


def _softmax_sim(a, c, prec):
    return torch.softmax(prec.mm(a, c.transpose(-1, -2))
                         / math.sqrt(a.shape[-1]), dim=-1)


def _qkv(y, p, heads, prec):
    q, k, v = linear(y, p["qkv"], prec).chunk(3, dim=-1)
    return _heads(q, heads), _heads(k, heads), _heads(v, heads)


def plain_attention(y, p, heads, prec):
    """-> (output [N, C], head-mean weights [N, N])."""
    q, k, v = _qkv(y, p, heads, prec)
    attn = _softmax_sim(q, k, prec)
    ctx = prec.mm(attn, v)
    return linear(_merge(ctx), p["out"], prec), attn.mean(0)


def surgery_attention(y, p, heads, prec, ex_attn=None):
    """-> (dense output, original output, head-summed original weights)."""
    q, k, v = _qkv(y, p, heads, prec)
    attn_ori = _softmax_sim(q, k, prec)
    mix = (_softmax_sim(q, q, prec) + _softmax_sim(k, k, prec)
           + _softmax_sim(v, v, prec)) / 3.0
    if ex_attn is not None:
        mix = mix.clone()
        mix[:, 1:, 1:] += ex_attn[None]
    shared = mix.sum(0)
    dense = linear(_merge(prec.mm(shared[None], v)), p["out"], prec)
    ori = linear(_merge(prec.mm(attn_ori, v)), p["out"], prec)
    return dense, ori, attn_ori.sum(0)


def pos_embedding(pos, side):
    """[1 + S*S, C] table resized to side x side (half-pixel bilinear; the
    cells only upsample, where no antialiasing applies)."""
    s = int(round((pos.shape[0] - 1) ** 0.5))
    if s == side:
        return pos.float()
    if side < s:
        raise NotImplementedError("downsampling the positional table "
                                  "antialiases; no cell needs it")
    grid = pos[1:].float().reshape(s, s, -1).permute(2, 0, 1)[None]
    grid = F.interpolate(grid, size=(side, side), mode="bilinear",
                         align_corners=False)
    return torch.cat([pos[:1].float(),
                      grid[0].permute(1, 2, 0).reshape(side * side, -1)])


def vision_forward(visual, image, heads, surgery, window, prec=FP32,
                   ex_attn=None, need_attn=True, stack=False):
    """One normalised image [H, W, 3] -> {"projected" [N, E], "attn"
    [N, N] (the mean over the last `window` blocks of the head-mean
    (plain) or head-sum (surgery) weights) or None, "feats" [L, N, width]}.
    ex_attn: optional [M, M] calibration added to each surgery block's
    patch-patch mix. stack: also "stack" [window, N, N], the blocks' own
    weights."""
    w = visual["patch_embed"].float()
    width, _, ps, _ = w.shape
    h, wd, _ = image.shape
    gh, gw = h // ps, wd // ps
    patches = image[:gh * ps, :gw * ps].reshape(gh, ps, gw, ps, 3)
    patches = patches.permute(0, 2, 4, 1, 3).reshape(gh * gw, 3 * ps * ps)
    x = prec.mm(patches, w.reshape(width, -1).t())
    x = torch.cat([visual["class_embedding"].float()[None], x])
    x = x + pos_embedding(visual["positional_embedding"], gh)
    x = layer_norm(x, visual["ln_pre"])
    blocks = visual["blocks"]
    n_single = len(blocks) - surgery
    acc = None
    per_block = []
    single, ori_feats, ori_res = [], [], []
    x_ori = None
    for i, blk in enumerate(blocks):
        if i < n_single:
            y, wts = plain_attention(layer_norm(x, blk["ln_1"]), blk["attn"],
                                     heads, prec)
            x = x + y
            x = x + mlp(layer_norm(x, blk["ln_2"]), blk["mlp"], prec)
            single.append(x)
        else:
            src = x if x_ori is None else x_ori
            dense, ori, wts = surgery_attention(
                layer_norm(src, blk["ln_1"]), blk["attn"], heads, prec,
                ex_attn)
            x_ori = src + ori
            x_ori = x_ori + mlp(layer_norm(x_ori, blk["ln_2"]), blk["mlp"],
                                prec)
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
    x = layer_norm(x, visual["ln_post"])
    projected = prec.mm(x, visual["proj"].float())
    projected = projected / projected.norm(dim=0, keepdim=True)
    out = {"projected": projected,
           "attn": acc / window if need_attn else None,
           "feats": torch.stack(feats)}
    if stack:
        out["stack"] = torch.stack(per_block)
    return out


def feature_surgery(img, txt):
    """LAM scores [N, T] of normalised tokens img [N, C] against the text
    bank [T, C], min-max normalised over the tokens."""
    img, txt = img.float(), txt.float()
    prob = torch.softmax(img[0] @ txt.t() * 2.0, dim=-1)
    w = prob / prob.mean()
    sim = (img @ txt.t()) * w[None]
    sim = sim - (img @ (w @ txt / txt.shape[0]))[:, None]
    lo = sim.amin(dim=0, keepdim=True)
    hi = sim.amax(dim=0, keepdim=True)
    return (sim - lo) / (hi - lo)


def lams(projected, text, num_fg):
    """fg LAMs [hw, num_fg]: patch tokens only, background columns
    dropped."""
    return feature_surgery(projected, text)[1:, :num_fg]


def feature_sim(feats):
    """Cosine similarity [M, M] of one image's [M, C] head features."""
    f = feats.float()
    f = f / f.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return f @ f.t()


def external_feature_attention_from_sim(sim, mean, beta=1.0, gamma=3.0):
    """LVC calibration [M, M]: softmax of gamma * (similarity - beta *
    mean), entries below 0 set to -inf; `mean` is the similarity's mean
    over the whole batch (the program takes it over the batch tensor)."""
    sim = (sim - mean * beta) * gamma
    sim = torch.where(sim < 0, torch.full_like(sim, -torch.inf), sim)
    return torch.softmax(sim, dim=-1)


IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def normalize(image):
    """[H, W, 3] 0-255 -> ImageNet-normalised float32: (x - mean) times
    the float32 reciprocal of std, as the model's compiled programs form
    the division by a constant (training's PAR guide floors x * std + mean
    again, where one rounding moves a whole grey level)."""
    mean = torch.tensor(IMAGENET_MEAN, device=image.device)
    inv_std = 1.0 / torch.tensor(IMAGENET_STD, device=image.device)
    return (image.float() - mean) * inv_std
