"""The port's CUDA kernels against their plain versions on a GPU.

These need a CUDA device and nvcc; elsewhere they skip. On a machine with
the card: python -m pytest -m cuda tests/test_torch_kernels_gpu.py -q
"""
import pytest
import torch

from excel_tpu_torch import build
from excel_tpu_torch.models import attention_kernels as ak
from excel_tpu_torch.ops.par import _offsets, _pos_weight, _replicate_valid
from excel_tpu_torch.ops import par_kernels as pk

pytestmark = pytest.mark.cuda

ATOL = 1e-4     # fp32 sums in another order


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.Generator(device="cuda").manual_seed(0)


# N=17 and 197: tails of the 64-row query tiles and of the 64-key chunks
@pytest.mark.parametrize("tokens,d", [(17, 32), (197, 64)])
@pytest.mark.parametrize("mode", ["none", "out", "acc"])
def test_plain_attention_kernel(gen, tokens, d, mode):
    q, k, v = (torch.randn((2, 3, tokens, d), device="cuda", generator=gen)
               for _ in range(3))
    acc = torch.rand((2, tokens, tokens), device="cuda", generator=gen)
    kw = dict(need_weights=mode != "none")
    got = ak.fused_plain_attention(
        q, k, v, acc=acc.clone() if mode == "acc" else None, **kw)
    ref = ak.plain_attention_reference(
        q, k, v, acc=acc.clone() if mode == "acc" else None, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            torch.testing.assert_close(g, r, atol=ATOL, rtol=0)


@pytest.mark.parametrize("tokens", [17, 197])
@pytest.mark.parametrize("mode", ["none", "out", "acc"])
def test_surgery_attention_kernel(gen, tokens, mode):
    q, k, v = (torch.randn((2, 3, tokens, 64), device="cuda", generator=gen)
               for _ in range(3))
    acc = torch.rand((2, tokens, tokens), device="cuda", generator=gen)
    ex = torch.rand((2, tokens, tokens), device="cuda", generator=gen)
    kw = dict(ex_attn=ex, need_attn=mode != "none")
    got = ak.fused_surgery_attention(
        q, k, v, acc=acc.clone() if mode == "acc" else None, **kw)
    ref = ak.surgery_attention_reference(
        q, k, v, acc=acc.clone() if mode == "acc" else None, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            torch.testing.assert_close(g, r, atol=ATOL, rtol=0)


# row 5's kernel at its offset sets: K=8 (dilation 1, pad 1), 48 (PAR's
# dilations, pad 24) and 72 (the CRF's, pad 55)
def _diffuse_offsets(k):
    if k == 72:
        from excel_tpu_torch.ops.crf_tpu import DEFAULT_DILATIONS
        from excel_tpu_torch.ops.crf_tpu import _offsets as crf_offsets

        return crf_offsets(DEFAULT_DILATIONS)
    return _offsets({8: (1,), 48: (1, 2, 4, 8, 12, 24)}[k])


# (K, B, C, h, w): 1, 2, 3, 8, 9, 21 and 81 channels (one to 21 channel
# passes); widths 61, 200, 300 and 640 (ragged and whole 64-column tiles);
# heights below the pad; a 1-row and a 1-column image
DIFFUSE_SHAPES = [(8, 2, 1, 1, 61), (8, 1, 3, 33, 1), (48, 1, 8, 1, 200),
                  (48, 2, 2, 20, 640), (48, 1, 9, 40, 61),
                  (72, 1, 3, 8, 300), (72, 2, 21, 40, 61),
                  (72, 1, 81, 16, 200), (72, 1, 9, 50, 640)]


def _diffuse_case(gen, k, b, c, h, w, dtype):
    offs = _diffuse_offsets(k)
    masks = torch.rand((b, c, h, w), device="cuda", generator=gen)
    aff = torch.rand((b, len(offs), h, w), device="cuda", generator=gen)
    aff = aff / aff.sum(dim=1, keepdim=True)
    return masks.to(dtype), aff.to(dtype), pk.offsets_tensor(offs, "cuda")


def _diffuse_bitwise(masks, aff, offsets):
    """The kernel against its plain version bit for bit, twice for equal
    bits, and once more on a side stream."""
    got = pk.par_diffuse(masks, aff, offsets)
    again = pk.par_diffuse(masks, aff, offsets)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = pk.par_diffuse(masks, aff, offsets)
    torch.cuda.current_stream().wait_stream(side)
    ref = pk.par_diffuse_reference(masks, aff, offsets)
    torch.cuda.synchronize()
    assert got.dtype == masks.dtype
    assert torch.equal(got, ref), float((got.float() - ref.float()).abs()
                                        .max())
    assert torch.equal(got, again) and torch.equal(got, on_side)


def test_par_diffuse_kernel_bitwise(gen):
    offs = _offsets((1, 2, 4, 8, 12, 24))
    masks = torch.rand((2, 10, 40, 300), device="cuda", generator=gen)
    aff = torch.rand((2, len(offs), 40, 300), device="cuda", generator=gen)
    valid = torch.tensor([[40, 300], [25, 170]], device="cuda")
    masks = _replicate_valid(masks, valid)
    offsets = pk.offsets_tensor(offs, "cuda")
    got = pk.par_diffuse(masks, aff, offsets)
    ref = pk.par_diffuse_reference(masks, aff, offsets)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,b,c,h,w", DIFFUSE_SHAPES)
def test_par_diffuse_kernel_shapes_bitwise(gen, k, b, c, h, w, dtype):
    _diffuse_bitwise(*_diffuse_case(gen, k, b, c, h, w, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 72])
def test_par_diffuse_kernel_unaligned_bitwise(gen, k, dtype):
    """Masks and affinities at an odd element offset (a batch sliced off
    the front of an odd-sized one): no 16-byte copy or 4-byte pair is
    aligned."""
    masks, aff, offsets = _diffuse_case(gen, k, 3, 3, 7, 61, dtype)
    _diffuse_bitwise(masks[1:], aff[1:], offsets)


# bf16 outputs against their plain versions: at most one bf16 ulp of the
# reference's own size, |got - ref| <= 2^-7 |ref| (the contexts round fp32
# sums taken in another order; the affinity's exp and reciprocal differ by
# an fp32 ulp); a dropped term or a wrong tile is off by far more. Plus
# the smallest normal fp32, for subnormal values, whose bf16 ulp is coarser
# than 2^-7 of them
BF16_RTOL = 2.0 ** -7
BF16_ATOL = torch.finfo(torch.float32).tiny
# the bf16 attention contexts get two more terms: 2^-20 max|v| (the tensor
# cores sum an instruction's 16 products without rounding each partial sum,
# which shows where a context cancels to nearly 0) and the rounding
# allowance of p (a normalised p at a bf16 tie may round either way; one
# bf16 ulp of exactly those p times |v|, 0 elsewhere)
CTX_ABS_OF_VMAX = 2.0 ** -20


def _ctx_close(got, ref, q, k, v):
    assert got.dtype == ref.dtype
    g, r = got.float(), ref.float()
    lim = BF16_RTOL * r.abs() + BF16_ATOL if got.dtype == torch.bfloat16 \
        else torch.full_like(r, ATOL)
    lim = lim + ak.context_rounding_allowance(q, k, v) \
        + (CTX_ABS_OF_VMAX * float(v.float().abs().max())
           if got.dtype == torch.bfloat16 else 0.0)
    assert torch.isfinite(g).all()
    bad = (g - r).abs() > lim
    assert not bad.any(), (int(bad.sum()), float((g - r).abs().max()))


def _qkv(gen, b, h, n, d, dtype):
    return [torch.randn((b, h, n, d), device="cuda", generator=gen).to(dtype)
            for _ in range(3)]


def _attention(kind, q, k, v, mode, acc, ex=None):
    """(fused outputs, plain outputs) with output 1 the accumulated one."""
    def a():
        return acc.clone() if mode == "acc" else None
    if kind == "plain":
        kw = dict(need_weights=mode != "none")
        got = ak.fused_plain_attention(q, k, v, acc=a(), **kw)
        ref = ak.plain_attention_reference(q, k, v, acc=a(), **kw)
        return (got[1], got[0]), (ref[1], ref[0])
    kw = dict(ex_attn=ex, need_attn=mode != "none")
    got = ak.fused_surgery_attention(q, k, v, acc=a(), **kw)
    ref = ak.surgery_attention_reference(q, k, v, acc=a(), **kw)
    return (got[1], got[2], got[0]), (ref[1], ref[2], ref[0])


def _check_attention(kind, q, k, v, mode, acc, ex=None):
    got, ref = _attention(kind, q, k, v, mode, acc, ex)
    torch.cuda.synchronize()
    assert (got[0] is None) == (mode == "none")
    _ctx_close(got[1], ref[1], q, k, v)
    for g, r in zip(got[::2], ref[::2]):       # fp32 [B, N, N] outputs
        assert (g is None) == (r is None)
        if g is not None:
            torch.testing.assert_close(g, r, atol=ATOL, rtol=0)
    return got


# ragged and tiny token counts: one key, tails of 1 and 15 rows on either
# side of the 16-row fragments and the 64-row tiles; D=32 and 64; every mode
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["none", "out", "acc"])
@pytest.mark.parametrize("tokens", [1, 15, 17, 63, 65])
@pytest.mark.parametrize("d", [32, 64])
def test_attention_kernels_edge_tokens(gen, d, tokens, mode, dtype):
    q, k, v = _qkv(gen, 2, 3, tokens, d, dtype)
    acc = torch.rand((2, tokens, tokens), device="cuda", generator=gen)
    _check_attention("plain", q, k, v, mode, acc)
    _check_attention("surgery", q, k, v, mode, acc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["none", "out", "acc"])
@pytest.mark.parametrize("b", [1, 3])
def test_surgery_attention_kernel_ex_every_mode(gen, b, mode, dtype):
    n = 130
    q, k, v = _qkv(gen, b, 12, n, 64, dtype)
    acc = torch.rand((b, n, n), device="cuda", generator=gen)
    ex = (torch.rand((b, n, n), device="cuda", generator=gen)
          / n).to(dtype).float()
    _check_attention("surgery", q, k, v, mode, acc, ex)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["plain", "surgery"])
def test_attention_kernels_deterministic_and_acc_is_out_plus_acc(gen, kind,
                                                                 dtype):
    """Two launches give the same bits (no atomics, fixed order of the head
    sums), and mode acc equals mode out + the accumulator bit for bit."""
    n = 197
    q, k, v = _qkv(gen, 2, 12, n, 64, dtype)
    acc = torch.rand((2, n, n), device="cuda", generator=gen)
    first, _ = _attention(kind, q, k, v, "acc", acc)
    again, _ = _attention(kind, q, k, v, "acc", acc)
    out, _ = _attention(kind, q, k, v, "out", acc)
    torch.cuda.synchronize()
    for a, b2 in zip(first, again):
        assert torch.equal(a, b2)
    assert torch.equal(first[0], out[0] + acc)
    for a, o in zip(first[1:], out[1:]):
        assert torch.equal(a, o)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_on_a_side_stream(gen, dtype):
    """The kernels and their scratch follow PyTorch's current stream."""
    n = 401
    q, k, v = _qkv(gen, 2, 12, n, 64, dtype)
    acc = torch.rand((2, n, n), device="cuda", generator=gen)
    ref_p, _ = _attention("plain", q, k, v, "out", acc)
    ref_s, _ = _attention("surgery", q, k, v, "out", acc)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got_p, _ = _attention("plain", q, k, v, "out", acc)
        got_s, _ = _attention("surgery", q, k, v, "out", acc)
    side.synchronize()
    for g, r in zip(got_p + got_s, ref_p + ref_s):
        assert torch.equal(g, r)


@pytest.mark.parametrize("tokens", [17, 197])
@pytest.mark.parametrize("mode", ["none", "out", "acc"])
def test_plain_attention_kernel_bf16(gen, tokens, mode):
    q, k, v = (torch.randn((2, 3, tokens, 64), device="cuda", generator=gen)
               .bfloat16() for _ in range(3))
    acc = torch.rand((2, tokens, tokens), device="cuda", generator=gen)
    kw = dict(need_weights=mode != "none")
    got = ak.fused_plain_attention(
        q, k, v, acc=acc.clone() if mode == "acc" else None, **kw)
    ref = ak.plain_attention_reference(
        q, k, v, acc=acc.clone() if mode == "acc" else None, **kw)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.bfloat16
    _ctx_close(got[0], ref[0], q, k, v)
    if mode != "none":
        torch.testing.assert_close(got[1], ref[1], atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["none", "out", "acc"])
def test_surgery_attention_kernel_bf16(gen, mode):
    q, k, v = (torch.randn((2, 3, 197, 64), device="cuda", generator=gen)
               .bfloat16() for _ in range(3))
    acc = torch.rand((2, 197, 197), device="cuda", generator=gen)
    kw = dict(need_attn=mode != "none")
    got = ak.fused_surgery_attention(
        q, k, v, acc=acc.clone() if mode == "acc" else None, **kw)
    ref = ak.surgery_attention_reference(
        q, k, v, acc=acc.clone() if mode == "acc" else None, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], ref[0], atol=ATOL, rtol=0)
    _ctx_close(got[2], ref[2], q, k, v)
    if mode != "none":
        torch.testing.assert_close(got[1], ref[1], atol=ATOL, rtol=0)


def _canvas(gen, dtype, b=3, c=5, h=40, w=200):
    x = torch.rand((b, c, h, w), device="cuda", generator=gen).to(dtype)
    valid = torch.tensor([[40, 200], [25, 170], [9, 31]][:b], device="cuda",
                         dtype=torch.int32)
    return x, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pad_clamp_kernel_bitwise(gen, dtype):
    x, valid = _canvas(gen, dtype)
    got = pk.pad_replicate_valid(x, valid, 24)
    ref = pk.pad_replicate_valid_reference(x, valid, 24)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_affinity_kernel(gen):
    """Same order of rounding; exp and the divisions by a Python scalar
    (which PyTorch's CUDA division takes as a product with the
    reciprocal) differ by an fp32 ulp, which can move a bf16 affinity by
    one bf16 ulp of its own size. The kernel writes bf16 only."""
    dil = (1, 2, 4, 8, 12, 24)
    img, valid = _canvas(gen, torch.float32, c=3)
    ip = pk.pad_replicate_valid(img, valid, 24)
    offsets = _offsets(dil)
    pos_w = [float(p) for p in _pos_weight(dil)]
    got = pk.par_affinity(ip, offsets, pos_w, 40, 200)
    ref = pk.par_affinity_reference(ip, offsets, pos_w, 40, 200)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), atol=BF16_ATOL,
                               rtol=BF16_RTOL)
    with pytest.raises(NotImplementedError):
        pk.par_affinity(ip, offsets, pos_w, 40, 200, out_dtype=torch.float32)


def test_diffuse_valid_kernels_bitwise(gen):
    """The step kernel equals its plain version, and one resident launch of
    6 steps equals 6 step launches, bit for bit (bf16; 9 channels: two
    passes over the affinities, of 5 and 4 channels)."""
    dil = (1, 2, 4, 8, 12, 24)
    offsets = _offsets(dil)
    masks, valid = _canvas(gen, torch.bfloat16, c=9)
    mp = pk.pad_replicate_valid(masks, valid, 24)
    aff = torch.rand((3, len(dil) * 8, 40, 200), device="cuda", generator=gen)
    aff = (aff / aff.sum(dim=1, keepdim=True)).bfloat16()
    step = pk.par_diffuse_padded_valid(mp, aff, valid, offsets, 40, 200)
    ref = pk.par_diffuse_padded_valid_reference(mp, aff, valid, offsets, 40,
                                                200)
    m = mp
    for _ in range(6):
        m = pk.par_diffuse_padded_valid(m, aff, valid, offsets, 40, 200)
    res = pk.par_diffuse_valid_resident(mp, aff, valid, offsets, 40, 200, 6)
    torch.cuda.synchronize()
    assert torch.equal(step, ref)
    assert torch.equal(res, m)
    with pytest.raises(NotImplementedError):
        pk.par_diffuse_padded_valid(mp.float(), aff.float(), valid, offsets,
                                    40, 200)


def _diffuse_valid_case(gen, c, w, dil, hp_extra=8, wp=None):
    """bf16 canvas, affinities and extents of 4 images of height 40 and
    width w: one full, one ragged, one a single row, one a single column."""
    offs = _offsets(dil)
    pad = max(dil)
    valid = torch.tensor([[40, w], [25, w * 2 // 3 + 1], [1, w - 7], [33, 1]],
                         device="cuda", dtype=torch.int32)
    masks = torch.rand((4, c, 40, w), device="cuda", generator=gen).bfloat16()
    wp = wp or -(-(w + 2 * pad) // 128) * 128
    mp = pk._clamped_gather(masks, valid, pad, 40 + 2 * pad + hp_extra, wp)
    aff = torch.rand((4, len(offs), 40, w), device="cuda", generator=gen)
    aff = (aff / aff.sum(dim=1, keepdim=True)).bfloat16()
    return mp, aff, valid, offs


# pad 24 (the production dilations, K=48) and pad 3 (K=16: odd column
# offsets, whose mask pairs are not 4-byte aligned)
@pytest.mark.parametrize("dil", [(1, 2, 4, 8, 12, 24), (1, 3)])
@pytest.mark.parametrize("w", [61, 200, 512])
@pytest.mark.parametrize("c", [1, 4, 5, 8, 9])
def test_diffuse_valid_resident_edges_bitwise(gen, c, w, dil):
    """Resident == iterated step launches == plain version, bit for bit,
    for 1, 2, 7 and 20 steps: one pass over the affinities up to 8
    channels, two at 9; widths that break the 16-byte copies (61) and
    extents of one row or one column."""
    mp, aff, valid, offs = _diffuse_valid_case(gen, c, w, dil)
    m, plain = mp, mp
    for n in range(1, 21):
        m = pk.par_diffuse_padded_valid(m, aff, valid, offs, 40, w)
        plain = pk.par_diffuse_padded_valid_reference(plain, aff, valid, offs,
                                                      40, w)
        if n in (1, 2, 7, 20):
            res = pk.par_diffuse_valid_resident(mp, aff, valid, offs, 40, w,
                                                n)
            torch.cuda.synchronize()
            assert torch.equal(m, plain), n
            assert torch.equal(res, plain), n


def test_diffuse_valid_odd_canvas_and_unaligned_pointers(gen):
    """An odd canvas width and height, and tensors that start 2 bytes past
    a 16-byte boundary: every copy and store takes its element path."""
    dil = (1, 2, 4, 8, 12, 24)
    mp, aff, valid, offs = _diffuse_valid_case(gen, 5, 200, dil, hp_extra=1,
                                               wp=200 + 48 + 3)
    big_m = torch.empty((mp.numel() + 1,), device="cuda", dtype=mp.dtype)
    big_a = torch.empty((aff.numel() + 1,), device="cuda", dtype=aff.dtype)
    mp_u = big_m[1:].view(mp.shape).copy_(mp)
    aff_u = big_a[1:].view(aff.shape).copy_(aff)
    ref = pk.par_diffuse_valid_resident_reference(mp, aff, valid, offs, 40,
                                                  200, 7)
    got = pk.par_diffuse_valid_resident(mp_u, aff_u, valid, offs, 40, 200, 7)
    step = pk.par_diffuse_padded_valid(mp_u, aff_u, valid, offs, 40, 200)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(step, pk.par_diffuse_padded_valid_reference(
        mp, aff, valid, offs, 40, 200))


def test_diffuse_valid_deterministic_and_on_a_side_stream(gen):
    """Two launches give the same bits, and a launch on a side stream the
    same bits as on the default stream."""
    mp, aff, valid, offs = _diffuse_valid_case(gen, 4, 512,
                                               (1, 2, 4, 8, 12, 24))
    a = pk.par_diffuse_valid_resident(mp, aff, valid, offs, 40, 512, 20)
    b = pk.par_diffuse_valid_resident(mp, aff, valid, offs, 40, 512, 20)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        c = pk.par_diffuse_valid_resident(mp, aff, valid, offs, 40, 512, 20)
        s = pk.par_diffuse_padded_valid(mp, aff, valid, offs, 40, 512)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(s, pk.par_diffuse_padded_valid_reference(
        mp, aff, valid, offs, 40, 512))
    # beyond the kernel's table of 128 offsets
    with pytest.raises(NotImplementedError):
        pk.par_diffuse_padded_valid(mp, aff[:, :1].repeat(1, 129, 1, 1),
                                    valid, (offs * 3)[:129], 40, 512)


def test_surgery_attention_kernel_bf16_with_ex(gen):
    """The calibrated train pass: bf16 q/k/v with an ex mask of bf16 values
    carried in fp32 (zero CLS row and column), no weights."""
    q, k, v = (torch.randn((2, 3, 197, 64), device="cuda", generator=gen)
               .bfloat16() for _ in range(3))
    ex = torch.rand((2, 196, 196), device="cuda", generator=gen) / 196
    ex = torch.nn.functional.pad(ex.bfloat16().float(), (1, 0, 1, 0))
    got = ak.fused_surgery_attention(q, k, v, ex_attn=ex, need_attn=False)
    ref = ak.surgery_attention_reference(q, k, v, ex_attn=ex,
                                         need_attn=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], ref[0], atol=ATOL, rtol=0)
    _ctx_close(got[2], ref[2], q, k, v)


@pytest.mark.parametrize("c,h,w", [(5, 40, 56), (9, 40, 56), (1, 20, 61),
                                   (5, 64, 200)])
def test_row8_padded_hcw_step_via_diffuse_kernel(gen, c, h, w):
    """Pallas row 8 (full-extent fp32 step on the edge-padded [B, H+2P, C8,
    Wp] canvas) computed by row 5's kernel on the unpadded masks: 20
    chained steps within 1e-5 of the plain row 8."""
    dil = (1, 2, 4, 8, 12, 24)
    offs = _offsets(dil)
    masks = torch.rand((2, c, h, w), device="cuda", generator=gen)
    aff = torch.rand((2, len(offs), h, w), device="cuda", generator=gen)
    aff = aff / aff.sum(dim=1, keepdim=True)
    m_k = masks
    m_r = pk.pad_for_diffuse_hcw(masks, 24)
    offsets = pk.offsets_tensor(offs, "cuda")
    for _ in range(20):
        m_k = pk.par_diffuse(m_k, aff, offsets)
        m_r = pk.par_diffuse_padded_hcw_reference(m_r, aff, offs, h, w)
    torch.cuda.synchronize()
    interior = m_r[:, 24:24 + h, :c, 24:24 + w].permute(0, 2, 1, 3)
    torch.testing.assert_close(m_k, interior, atol=1e-5, rtol=0)


def test_row6_padded_step_via_valid_kernel_bitwise(gen):
    """Pallas row 6 (full-extent bf16 step, border kept by the step)
    computed by row 7's kernel with every extent the whole image: 3
    chained steps bit for bit."""
    dil = (1, 2, 4, 8, 12, 24)
    offs = _offsets(dil)
    masks = torch.rand((2, 5, 40, 56), device="cuda", generator=gen)
    aff = torch.rand((2, len(offs), 40, 56), device="cuda", generator=gen)
    aff = (aff / aff.sum(dim=1, keepdim=True)).bfloat16()
    full = torch.tensor([[40, 56]] * 2, device="cuda", dtype=torch.int32)
    m_k = m_r = pk.pad_for_diffuse(masks.bfloat16(), 24)
    for _ in range(3):
        m_k = pk.par_diffuse_padded_valid(m_k, aff, full, offs, 40, 56)
        m_r = pk.par_diffuse_padded_reference(m_r, aff, offs, 40, 56)
    torch.cuda.synchronize()
    assert torch.equal(m_k, m_r)


def test_denormalize_images_card_equals_cpu():
    """The PAR guidance of training on every byte value: the card's
    float64 products and sums round as the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from excel_tpu_torch.engine.pipeline import (denormalize_images,
                                                 normalize_images)

    u8 = torch.arange(256, dtype=torch.uint8)[None, :, None].expand(
        1, 256, 3).contiguous()
    cpu = denormalize_images(normalize_images(u8))
    card = denormalize_images(normalize_images(u8.cuda())).cpu()
    assert torch.equal(cpu, card)


# ---------------------------------------------------------------------------
# the mean-field CRF's message pass (row 5 at 72 offsets, fp32 and bf16) and
# the MSC shapes' launch attribution
# ---------------------------------------------------------------------------

def _crf_inputs(gen, c, dtype):
    from excel_tpu_torch.ops.crf_tpu import DEFAULT_DILATIONS
    from excel_tpu_torch.ops.crf_tpu import _offsets as crf_offsets

    offs = crf_offsets(DEFAULT_DILATIONS)
    q = torch.rand((2, c, 40, 300), device="cuda", generator=gen)
    q = (q / q.sum(dim=1, keepdim=True)).to(dtype)
    aff = torch.rand((2, len(offs), 40, 300), device="cuda", generator=gen)
    aff = (4.0 * aff / aff.sum(dim=1, keepdim=True)).to(dtype)
    return q, aff, pk.offsets_tensor(offs, "cuda")


# 1 to 81 channels: one to 21 channel passes, the last one partly filled
@pytest.mark.parametrize("c", [1, 2, 3, 8, 9, 21, 81])
def test_par_diffuse_bf16_kernel_bitwise(gen, c):
    """The bf16 entry point against its plain version (products rounded to
    bf16, fp32 sums in chunks of 8, a bf16 running output), bit for bit,
    at the CRF's 72 offsets with a pad (55) beyond the canvas height."""
    q, aff, offsets = _crf_inputs(gen, c, torch.bfloat16)
    before = pk.par_diffuse.launches_by_type.copy()
    got = pk.par_diffuse(q, aff, offsets)
    ref = pk.par_diffuse_reference(q, aff, offsets)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref)
    assert pk.par_diffuse.launches_by_type - before == {
        (torch.bfloat16, 72): 1}


def test_par_diffuse_fp32_kernel_at_crf_offsets_bitwise(gen):
    q, aff, offsets = _crf_inputs(gen, 21, torch.float32)
    got = pk.par_diffuse(q, aff, offsets)
    torch.cuda.synchronize()
    assert torch.equal(got, pk.par_diffuse_reference(q, aff, offsets))
    with pytest.raises(ValueError, match="share a dtype"):
        pk.par_diffuse(q, aff.bfloat16(), offsets)


@pytest.mark.parametrize("msg_dtype", [None, torch.bfloat16])
def test_crf_meanfield_card_matches_cpu(gen, msg_dtype):
    """The whole mean-field (valid extents, coarse level, 3 iterations) on
    the card (message pass through the kernel) against the CPU (its plain
    version). The build's exp and rsqrt differ by ulps between the devices:
    Q within 1e-4, argmax agreement >= 0.999."""
    from excel_tpu_torch.ops.crf_tpu import crf_meanfield

    img = torch.randint(0, 256, (2, 48, 160, 3), device="cuda",
                        generator=gen, dtype=torch.uint8)
    probs = torch.rand((2, 6, 48, 160), device="cuda", generator=gen) ** 3
    probs = probs / probs.sum(dim=1, keepdim=True)
    valid = torch.tensor([[48, 160], [37, 101]], device="cuda",
                         dtype=torch.int32)
    kw = dict(iters=3, msg_dtype=msg_dtype, coarse_stride=8)
    before = pk.par_diffuse.launches
    card = crf_meanfield(img, probs, valid_hw=valid, **kw).cpu()
    assert pk.par_diffuse.launches == before + 3
    cpu = crf_meanfield(img.cpu(), probs.cpu(), valid_hw=valid.cpu(), **kw)
    assert (card.argmax(1) == cpu.argmax(1)).float().mean() >= 0.999
    torch.testing.assert_close(card, cpu, atol=1e-4, rtol=0)


@pytest.mark.parametrize("tokens,plain_row,surgery_row", [
    (197, "_plain_kernel_rows_hb", "_kernel"),
    (577, "_plain_kernel", "_kernel"),
    (901, "_plain_kernel", "_kernel_rows")])
def test_attention_none_mode_at_msc_tokens(gen, tokens, plain_row,
                                           surgery_row):
    """Mode "none" (MSC's: no weights, surgery without ex) at the token
    counts of MSC scales 0.7, 1.2 and 1.5, bf16 and fp32, and the Pallas
    row each launch is attributed to."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((1, 12, tokens, 64), device="cuda",
                               generator=gen).to(dtype) for _ in range(3))
        rows_p = dict(ak.fused_plain_attention.launches_by_row)
        rows_s = dict(ak.fused_surgery_attention.launches_by_row)
        ctx, w = ak.fused_plain_attention(q, k, v, need_weights=False)
        shared, attn, ctx_ori = ak.fused_surgery_attention(q, k, v,
                                                           need_attn=False)
        torch.cuda.synchronize()
        assert w is None and attn is None
        rows_p[plain_row] += 1
        rows_s[surgery_row] += 1
        assert ak.fused_plain_attention.launches_by_row == rows_p
        assert ak.fused_surgery_attention.launches_by_row == rows_s
        ref_ctx, _ = ak.plain_attention_reference(q, k, v,
                                                  need_weights=False)
        ref_shared, _, ref_ori = ak.surgery_attention_reference(
            q, k, v, need_attn=False)
        _ctx_close(ctx, ref_ctx, q, k, v)
        _ctx_close(ctx_ori, ref_ori, q, k, v)
        torch.testing.assert_close(shared, ref_shared, atol=ATOL, rtol=0)


# -- pad-clamp and affinity: edges of their tiles and vectors ---------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad", [3, 8, 16, 24])
@pytest.mark.parametrize("w", [61, 200, 512])
def test_pad_clamp_kernel_edges_bitwise(gen, dtype, pad, w):
    """16-byte vectors where P and W are multiples of the vector (4 fp32, 8
    bf16), the element path elsewhere (pad 3, w = 61); extents of the whole
    image, a ragged part and a single pixel."""
    x = torch.rand((3, 2, 40, w), device="cuda", generator=gen).to(dtype)
    valid = torch.tensor([[40, w], [25, w * 2 // 3 + 1], [1, 1]],
                         device="cuda", dtype=torch.int32)
    got = pk.pad_replicate_valid(x, valid, pad)
    ref = pk.pad_replicate_valid_reference(x, valid, pad)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pad_clamp_kernel_unaligned_and_on_a_side_stream(gen, dtype):
    """An input one element past a 16-byte boundary takes the element path;
    a launch on a side stream gives the same bits."""
    x, valid = _canvas(gen, dtype)
    big = torch.empty((x.numel() + 1,), device="cuda", dtype=dtype)
    x_u = big[1:].view(x.shape).copy_(x)
    ref = pk.pad_replicate_valid_reference(x, valid, 24)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got_u = pk.pad_replicate_valid(x_u, valid, 24)
        got_s = pk.pad_replicate_valid(x, valid, 24)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got_u, ref) and torch.equal(got_s, ref)


def _affinity_dilations(k, pad):
    """Dilations of K = 8 x their count offsets whose reach is `pad`."""
    return {8: (), 16: (1,), 48: (1, 2, 3, 4, 5),
            64: (1, 2, 3, 4, 5, 6, 7)}[k] + (pad,)


def _affinity_inputs(gen, k, pad, h, w, slack=True):
    """A padded fp32 image of 3 images of h x w (extents: whole, ragged, one
    pixel), with (slack) or without the canvas's alignment slack."""
    dil = _affinity_dilations(k, pad)
    img = torch.rand((3, 3, h, w), device="cuda", generator=gen)
    valid = torch.tensor([[h, w], [max(h * 2 // 3, 1), max(w // 2, 1)],
                          [1, 1]], device="cuda", dtype=torch.int32)
    hp, wp = pk.padded_shape(h, w, pad) if slack else (h + 2 * pad,
                                                       w + 2 * pad)
    ip = pk._clamped_gather(img, valid, pad, hp, wp).contiguous()
    return ip, _offsets(dil), [float(p) for p in _pos_weight(dil)]


def _affinity_close(ip, offs, pos_w, h, w):
    """The kernel against its plain version run on the CPU, within one bf16
    ulp (exp differs by an fp32 ulp). On the CPU the plain version divides
    by K as the kernel does (IEEE division); on the card PyTorch multiplies
    by 1/K, and where the neighbours' variance cancels to nearly 0 (the
    replicated border) that ulp scales the logits, which the far offsets'
    tiny affinities show unmasked by their position terms (2 of 325,008
    values beyond one bf16 ulp at K=48, pad 24, 37 x 61)."""
    got = pk.par_affinity(ip, offs, pos_w, h, w)
    ref = pk.par_affinity_reference(ip.cpu(), offs, pos_w, h, w)
    torch.testing.assert_close(got.float().cpu(), ref.float(),
                               atol=BF16_ATOL, rtol=BF16_RTOL)
    return got


@pytest.mark.parametrize("slack", [True, False])
@pytest.mark.parametrize("pad", [8, 16, 24])
@pytest.mark.parametrize("k", [8, 16, 48, 64])
def test_affinity_kernel_edges(gen, k, pad, slack):
    """Within one bf16 ulp of the plain version (see test_affinity_kernel)
    for K = 8 ... 64 and pads 8 ... 24, at 40 x 200 (a ragged last tile
    down and across) and 37 x 61 (odd: bf16 pairs stored one by one), on a
    canvas with and without slack (an odd Wp: 61 + 2P)."""
    for h, w in ((40, 200), (37, 61)):
        _affinity_close(*_affinity_inputs(gen, k, pad, h, w, slack), h, w)


@pytest.mark.parametrize("pad,tiling", [(30, (8, 9216)), (33, (32, 19328)),
                                        (46, (16, 19328)), (52, (8, 19328))])
def test_affinity_kernel_smaller_tiles(gen, pad, tiling):
    """Pads whose slabs take 8- and 16-row tiles or the large channel
    plane (one block an SM); a pad beyond 52, where no slab fits, runs the
    direct kernel."""
    assert pk.affinity_tiling(pad) == tiling
    _affinity_close(*_affinity_inputs(gen, 8, pad, 40, 70), 40, 70)
    ip, offs, pos_w = _affinity_inputs(gen, 8, 53, 20, 30)
    direct = pk.par_affinity.launches_by_kernel["direct"]
    _affinity_close(ip, offs, pos_w, 20, 30)
    assert pk.par_affinity.launches_by_kernel["direct"] == direct + 1


def _direct_affinity(ip, offs, pos_w, h, w):
    """The direct kernel through its entry point, at any shape."""
    out = torch.empty((ip.shape[0], len(offs), h, w), device="cuda",
                      dtype=torch.bfloat16)
    fn = build.load("par_affinity", "excel_par_affinity_direct_bf16")
    build.check(fn(ip.data_ptr(), pk.offsets_tensor(offs, "cpu").data_ptr(),
                   pk.position_terms(pos_w, 0.01, "cpu").data_ptr(),
                   out.data_ptr(), ip.shape[0], h, w, ip.shape[2],
                   ip.shape[3], len(offs), max(max(abs(d) for d in o)
                                               for o in offs), 0.3,
                   torch.cuda.current_stream().cuda_stream),
                "par_affinity (direct)")
    return out


@pytest.mark.parametrize("k,pad", [(8, 56), (48, 64), (64, 56), (72, 24),
                                   (72, 40), (128, 64)])
def test_affinity_direct_kernel(gen, k, pad):
    """The direct kernel (pads the slab does not take, K beyond 64): within
    one bf16 ulp of the plain version (see test_affinity_kernel) at 40 x 200
    and 37 x 61, with and without the canvas's slack."""
    dil = {8: (), 48: (1, 2, 3, 4, 5), 64: (1, 2, 3, 4, 5, 6, 7),
           72: (1, 2, 3, 4, 5, 6, 7, 8), 128: tuple(range(1, 16))}[k] + (pad,)
    for h, w in ((40, 200), (37, 61)):
        for slack in (True, False):
            img = torch.rand((3, 3, h, w), device="cuda", generator=gen)
            valid = torch.tensor([[h, w], [h * 2 // 3, w // 2], [1, 1]],
                                 device="cuda", dtype=torch.int32)
            hp, wp = pk.padded_shape(h, w, pad) if slack else (
                h + 2 * pad, w + 2 * pad)
            ip = pk._clamped_gather(img, valid, pad, hp, wp).contiguous()
            offs = _offsets(dil)
            assert len(offs) == k
            assert pk.affinity_kernel(pad, k) == "direct"
            _affinity_close(ip, offs, [float(p) for p in _pos_weight(dil)],
                            h, w)


@pytest.mark.parametrize("k,pad", [(8, 8), (48, 24), (64, 52)])
def test_affinity_direct_kernel_equals_slab_kernel_bitwise(gen, k, pad):
    """Where both kernels take the shape, the same arithmetic gives the
    same bits, rare sums included (values near 1e-28, a spike of 1e12)."""
    h, w = 37, 200
    ip, offs, pos_w = _affinity_inputs(gen, k, pad, h, w)
    for img in (ip, ip * 1e-28, ip * 0 + 0.5):
        if img[0, 0, 0, 0] == 0.5:
            img[:, :, pad + 7, pad + 9] = 1e12
        slab = pk.par_affinity(img, offs, pos_w, h, w)
        direct = _direct_affinity(img, offs, pos_w, h, w)
        torch.cuda.synchronize()
        assert torch.equal(slab.isnan(), direct.isnan())
        assert torch.equal(slab.nan_to_num(), direct.nan_to_num())


def test_affinity_kernel_unaligned_side_stream_and_device_tables(gen):
    """An image one float past a 16-byte boundary; two launches and a
    launch on a side stream give the same bits; the entry point takes the
    offsets and position terms from device memory too (its copy waits for
    the stream) with the same result."""
    h, w, pad = 40, 200, 24
    ip, offs, pos_w = _affinity_inputs(gen, 48, pad, h, w)
    big = torch.empty((ip.numel() + 1,), device="cuda")
    ip_u = big[1:].view(ip.shape).copy_(ip)
    got = _affinity_close(ip_u, offs, pos_w, h, w)
    again = pk.par_affinity(ip, offs, pos_w, h, w)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = pk.par_affinity(ip, offs, pos_w, h, w)
    torch.cuda.current_stream().wait_stream(side)
    out = torch.empty_like(got)
    fn = build.load("par_affinity", "excel_par_affinity_bf16")
    build.check(fn(ip.data_ptr(), pk.offsets_tensor(offs, "cuda").data_ptr(),
                   pk.position_terms(pos_w, 0.01, "cuda").data_ptr(),
                   out.data_ptr(), ip.shape[0], h, w, ip.shape[2],
                   ip.shape[3], len(offs), pad, 0.3,
                   torch.cuda.current_stream().cuda_stream), "par_affinity")
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, on_side)
    assert torch.equal(got, out)


def test_affinity_kernel_rare_sums(gen):
    """Pixels whose sums of squared differences are subnormal (an image of
    values near 1e-28) or infinite (a spike of 1e12 on a flat image: its
    logits are -inf, its affinities NaN in both versions) take the
    kernel's out-of-line division by 3; a flat image (every sum 0) its
    fast one."""
    h, w, pad = 40, 200, 24
    ip, offs, pos_w = _affinity_inputs(gen, 48, pad, h, w)
    for img in (ip * 1e-28, torch.full_like(ip, 0.25), ip * 0 + 0.5):
        if img[0, 0, 0, 0] == 0.5:
            img[:, :, pad + 7, pad + 9] = 1e12
        got = pk.par_affinity(img, offs, pos_w, h, w)
        ref = pk.par_affinity_reference(img.cpu(), offs, pos_w, h, w)
        torch.testing.assert_close(got.float().cpu(), ref.float(),
                                   atol=BF16_ATOL, rtol=BF16_RTOL,
                                   equal_nan=True)


def test_to_device_stages_through_pinned_memory(gen):
    """The sweeps' host-to-card copies: equal arrays on the card, the
    staging tensor pinned (an asynchronous copy)."""
    import numpy as np

    from excel_tpu_torch.engine import evaluate as pev

    rng = np.random.default_rng(0)
    arrays = (rng.random((4, 64, 64, 3), dtype=np.float32),
              rng.integers(0, 255, (4, 96, 128)).astype(np.int32))
    pinned = []
    real = torch.Tensor.pin_memory

    def pin(self, *a, **k):
        out = real(self, *a, **k)
        pinned.append(out.is_pinned())
        return out

    torch.Tensor.pin_memory = pin
    try:
        got = pev._to_device(arrays, torch.device("cuda"))
    finally:
        torch.Tensor.pin_memory = real
    torch.cuda.synchronize()
    assert pinned == [True, True]
    for a, g in zip(arrays, got):
        assert g.is_cuda
        assert np.array_equal(g.cpu().numpy(), a)


# the fast preset's PAR beyond the affinity slab: pad 56 (K=56) and nine
# dilations (K=72, pad 40) take the padded route, as every 8-aligned pad
# does: pad-clamp, the direct affinity kernel, the resident diffusion with
# its table of up to 128 offsets; card against the CPU within one bf16 ulp
# of masks in [1, 2) (the affinities differ by a bf16 ulp at most,
# test_affinity_kernel; the diffusion agrees bit for bit)
@pytest.mark.parametrize("dil", [(1, 2, 4, 8, 12, 24, 56),
                                 (1, 2, 4, 8, 12, 16, 24, 32, 40)])
def test_par_refine_bf16_large_pads_card_matches_cpu(gen, dil):
    from excel_tpu_torch.ops.par import bf16_route, par_refine

    assert bf16_route(dil) == "padded"
    img = torch.randn((2, 3, 96, 128), device="cuda", generator=gen)
    masks = torch.rand((2, 5, 96, 128), device="cuda", generator=gen)
    valid = torch.tensor([[96, 128], [70, 101]], dtype=torch.int32,
                         device="cuda")
    direct = pk.par_affinity.launches_by_kernel["direct"]
    resident = pk.par_diffuse_valid_resident.launches
    got = par_refine(img, masks, dilations=dil, num_iter=20, valid_hw=valid,
                     dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert pk.par_affinity.launches_by_kernel["direct"] == direct + 1
    assert pk.par_diffuse_valid_resident.launches == resident + 1
    ref = par_refine(img.cpu(), masks.cpu(), dilations=dil, num_iter=20,
                     valid_hw=valid.cpu(), dtype=torch.bfloat16)
    torch.testing.assert_close(got.cpu(), ref, atol=2.0 ** -7, rtol=0)


@pytest.mark.parametrize("c", [1, 5, 9])
def test_diffuse_valid_resident_72_offsets_bitwise(gen, c):
    """Resident == plain version bit for bit at K=72 (nine dilations), the
    offset table beyond its former 64 entries, for 1 and 20 steps."""
    dil = (1, 2, 4, 8, 12, 16, 24, 32, 40)
    mp, aff, valid, offs = _diffuse_valid_case(gen, c, 200, dil)
    assert len(offs) == 72
    for n in (1, 20):
        res = pk.par_diffuse_valid_resident(mp, aff, valid, offs, 40, 200, n)
        ref = pk.par_diffuse_valid_resident_reference(mp, aff, valid, offs,
                                                      40, 200, n)
        torch.cuda.synchronize()
        assert torch.equal(res, ref), n
