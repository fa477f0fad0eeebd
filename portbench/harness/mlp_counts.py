"""The encoder MLP's operations and bytes, counted from its shapes
(harness/flops.py's rules), and the before-hook that adds each traced
call's least time to a run's work counts for `mlp_roofline.*`."""
from __future__ import annotations

from . import peaks


def mlp_layer(b: int, n: int, c: int, hidden: int, act_bytes: int,
              weight_bytes: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one call of a block's MLP (models/layers.mlp: fc,
    the activation, proj) on [b, n, c] tokens with a hidden width `hidden`
    (4 c: 16 n c^2 FLOPs an image). Bytes: the input and the output once,
    both linears' weights and biases once; the hidden activation is an
    intermediate and does not count."""
    flops = 4.0 * b * n * c * hidden
    nbytes = 2.0 * b * n * c * act_bytes \
        + (2.0 * c * hidden + hidden + c) * weight_bytes
    return flops, nbytes


def mlp_work(ctx, work):
    """A before-hook of the wrapper around models/clip.mlp(x, p, act):
    adds the call's least time (peaks.bound_s at the compute type's matrix
    peak) to work["mlp_bound_s"] while the device trace runs."""
    dtype = str(ctx.cfg.clip.compute_dtype).split(".")[-1]
    work.setdefault("mlp_bound_s", 0.0)

    def before(args, kwargs):
        if not ctx.spans.tracing:
            return
        x, p = args[0], args[1]
        b, n, c = x.shape
        w = p["fc"]["w"]
        f, nb = mlp_layer(b, n, c, w.shape[0], x.element_size(),
                          w.element_size())
        work["mlp_bound_s"] += peaks.bound_s(f, nb,
                                             peaks.matmul_peak(dtype))[0]
    return before
