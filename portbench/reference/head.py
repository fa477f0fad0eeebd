"""The LVC head's forward: per-block fuse MLPs, the channel fuse, the
3-layer transformer decoder and the classifier; and the feature affinity.

Restates excel_tpu_torch/models/head.py (`segformer_fuse` without dropout
or with a given channel mask, `decoder_forward`, `feature_affinity`) and
models/layers.py (`multi_head_attention`) in float32 for one image, as
differentiable plain operations. `p` maps the head's parameter names
("fuse_mlps.0.proj.w", ..., "classifier.b") to tensors; linear weights
are [out, in].
"""
from __future__ import annotations

import math

import torch

from .encoder import layer_norm


def _lin(x, p, name):
    return x @ p[name + ".w"].t() + p[name + ".b"]


def _ln(x, p, name):
    return layer_norm(x, {"scale": p[name + ".scale"],
                          "bias": p[name + ".bias"]})


def fuse(p, feats, num_blocks, keep=None):
    """feats [num_blocks, M, width] (patch tokens) -> fused [M, D]; keep:
    the dropout's scaled channel mask [D] (training), else none."""
    outs = [_lin(torch.relu(_lin(feats[i].float(), p, f"fuse_mlps.{i}.proj")),
                 p, f"fuse_mlps.{i}.proj2") for i in range(num_blocks)]
    fused = _lin(torch.cat(outs, dim=-1), p, "linear_fuse")
    return fused if keep is None else fused * keep[None]


def decoder(p, x, layers, heads):
    """x [M, D] -> (logits [M, num_classes], head-mean weights [layers, M,
    M])."""
    attns = []
    for i in range(layers):
        pre = f"decoder.{i}."
        y = _ln(x, p, pre + "ln_1")
        q, k, v = _lin(y, p, pre + "attn.qkv").chunk(3, dim=-1)
        m, d = q.shape
        q, k, v = (t.reshape(m, heads, d // heads).transpose(0, 1)
                   for t in (q, k, v))
        w = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(d // heads),
                          dim=-1)
        ctx = (w @ v).transpose(0, 1).reshape(m, d)
        x = x + _lin(ctx, p, pre + "attn.out")
        hid = _lin(_ln(x, p, pre + "ln_2"), p, pre + "mlp.fc")
        hid = hid * torch.sigmoid(1.702 * hid)
        x = x + _lin(hid, p, pre + "mlp.proj")
        attns.append(w.mean(0))
    return _lin(x, p, "classifier"), torch.stack(attns)


def feature_gram(fused):
    f = fused.float()
    f = f / f.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return f @ f.t()


def feature_affinity(gram, mean):
    """sigmoid(3 (gram - mean)), the mean taken over the whole batch."""
    return torch.sigmoid((gram - mean) * 3.0)
