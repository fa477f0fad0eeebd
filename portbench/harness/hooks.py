"""before-hooks of the measured layers' wrappers that add, while the
device trace runs, each call's least time from its shapes (harness/flops)
to the run's work counts: the readers of the `_roofline` metrics divide
them by the device time under the layer's span."""
from __future__ import annotations

from . import flops as F
from . import peaks


def attention_work(ctx, work):
    """before-hooks of the encoder's attention layers: the layer's FLOPs
    and bytes of each call made while the trace runs."""
    dtype = str(ctx.cfg.clip.compute_dtype).split(".")[-1]

    def hook(kind):
        def before(args, kwargs):
            if not ctx.spans.tracing:
                return
            y = args[0]
            b, n, c = y.shape
            if kind == "plain":
                wts = kwargs.get("attn_acc") is not None or \
                    kwargs.get("need_weights", True)
                ex = False
            else:
                wts = kwargs.get("attn_acc") is not None or \
                    kwargs.get("need_attn", True)
                ex = kwargs.get("ex_attn") is not None
            f, nb = F.attention_layer(kind, b, n, c, dtype, wts, ex)
            work["attn_bound_s"] += peaks.bound_s(
                f, nb, peaks.matmul_peak(dtype))[0]
        return before
    return hook


def par_work(ctx, work):
    def before(args, kwargs):
        if not ctx.spans.tracing:
            return
        imgs, masks = args[0], args[1]
        b, c, h, w = masks.shape
        k = 8 * len(kwargs.get("dilations", ctx.cfg.refine.par_dilations))
        f, nb = F.par_layer(b, c, h, w, k,
                            kwargs.get("num_iter", ctx.cfg.refine.par_iters))
        work["par_bound_s"] += peaks.bound_s(f, nb, peaks.FLOPS["float32"])[0]
    return before
