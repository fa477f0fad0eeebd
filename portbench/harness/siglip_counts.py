"""SigLIP So400m/14's operations and bytes, counted from its shapes
(harness/flops.py's rules: 2 FLOPs a multiply-add, each input read once,
each output written once, no intermediate), and the before-hook that adds
each traced call of the attention-pooling head's least time to a run's
work counts for `map_head_roofline.*`.

The tower has no CLS token (n = grid^2 tokens) and an MLP of hidden width
h = 4,304 (not 4 c = 4,608), and ends in the attention-pooling head in
place of a projection: flops.encoder_flops, which counts a CLS row, MLPs
of 4 c and a projection, would count the blocks 4.4% high and leave out
the head's 22 GFLOP an image."""
from __future__ import annotations

import types

from . import flops as F
from . import peaks

FP32 = 4


def map_head_flops(n: int, c: int, h: int) -> float:
    """The attention-pooling head (models/clip.map_head) on one image of n
    tokens: the probe's q (2 c^2), k and v of the original stream (4 n c^2)
    and the pooled query's attention over its n keys (4 n c), v of the
    dense stream (2 n c^2), the out-projection, LayerNorm and MLP over the
    1 + n rows (2 (n + 1) c^2 + 4 (n + 1) c h)."""
    return 2.0 * c * c + 4.0 * n * c * c + 4.0 * n * c + 2.0 * n * c * c \
        + 2.0 * (n + 1) * c * c + 4.0 * (n + 1) * c * h


def map_head_layer(b: int, n: int, c: int, h: int, act_bytes: int,
                   weight_bytes: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one call of the head on [b, n, c] streams: the
    probe's q once a call, the rest an image. Bytes: both streams read
    once, the [b, 1 + n, c] output written once; the in_proj (3 c^2 + 3 c),
    out_proj (c^2 + c) and MLP (2 c h + h + c) weights and biases once;
    the probe and ln_post's and the head LayerNorm's scale and shift in
    fp32 once."""
    flops = b * (map_head_flops(n, c, h) - 2.0 * c * c) + 2.0 * c * c
    nbytes = 2.0 * b * n * c * act_bytes + b * (n + 1) * c * act_bytes \
        + (4.0 * c * c + 4.0 * c + 2.0 * c * h + h + c) * weight_bytes \
        + 5.0 * c * FP32
    return flops, nbytes


def encoder_flops(ccfg, size: int, calibrated: bool = False) -> float:
    """Matrix products of one image through the surgery SigLIP tower at
    size x size: the patch embedding, every block's projections, attention
    products and MLP at hidden `ccfg.hidden` (4 n c h), the dense path's
    shared-weights product, and the attention-pooling head
    (`map_head_flops`). flops.encoder_flops's rules otherwise; calibrated
    adds nothing (an addition to the mix)."""
    g = size // ccfg.patch_size
    n = g * g
    c, h = ccfg.vision_width, ccfg.hidden
    single = ccfg.vision_layers - ccfg.surgery_blocks
    patch = 2.0 * n * c * 3 * ccfg.patch_size ** 2
    plain = 8.0 * n * c * c + 4.0 * n * n * c + 4.0 * n * c * h
    surgery = 10.0 * n * c * c + 12.0 * n * n * c + 4.0 * n * c * h
    return (patch + single * plain + ccfg.surgery_blocks * surgery
            + map_head_flops(n, c, h))


def flops_module():
    """harness/flops.py with `encoder_flops` this module's: the counts that
    drivers/lam_sweep.py reads through its `F`."""
    return types.SimpleNamespace(**dict(vars(F),
                                        encoder_flops=encoder_flops))


def map_head_work(ctx, work):
    """Before-hook of the wrapper around models/clip.map_head(p, x_ori,
    x_dense, heads, act, eps): adds the call's least time (peaks.bound_s
    at the compute type's matrix peak) to work["map_head_bound_s"] while
    the device trace runs."""
    dtype = str(ctx.cfg.clip.compute_dtype).split(".")[-1]
    work.setdefault("map_head_bound_s", 0.0)

    def before(args, kwargs):
        if not ctx.spans.tracing:
            return
        p, x = args[0], args[2]
        b, n, c = x.shape
        w = p["map_head"]["mlp"]["fc"]["w"]
        f, nb = map_head_layer(b, n, c, w.shape[0], x.element_size(),
                               w.element_size())
        work["map_head_bound_s"] += peaks.bound_s(
            f, nb, peaks.matmul_peak(dtype))[0]
    return before
