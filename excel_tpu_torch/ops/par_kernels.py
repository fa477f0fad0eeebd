"""PAR kernels: the CUDA kernels and their plain versions.

Counterparts of excel_tpu/ops/par_pallas.py, one wrapper per Pallas
function, with its name and its array shapes:

- `par_diffuse` (csrc/par_diffuse.cu, the Pallas `_diffuse_kernel`): one
  step over unpadded masks, reads clamped to the canvas, fp32 or bf16 (PAR's
  step; the message pass of the mean-field CRF, ops/crf_tpu.py); the halo
  the kernel stages is chosen on the host (`staged_pad`)

      new[b, c, y, x] = sum_k aff[b, k, y, x] * m[b, c, y + dy_k, x + dx_k];

- `pad_replicate_valid` (csrc/par_pad_clamp.cu, `_pad_clamp_kernel`): the
  valid-extent clamp and edge pad of a canvas, [B, C, H, W] ->
  [B, C, H + 2P + 8, roundup128(W + 2P)], slack included;
- `par_affinity` (csrc/par_affinity.cu, `_affinity_kernel`): the appearance
  affinity [B, K, h, w] from such a padded image, in tiles whose rows
  `affinity_tiling` picks from the pad, or, for a pad or a K the tiles do
  not take, by the file's direct kernel (`affinity_kernel`);
- `par_diffuse_padded_valid` and `par_diffuse_valid_resident`
  (csrc/par_diffuse_valid.cu, `_diffuse_padded_valid_kernel` and
  `_diffuse_resident_kernel`): one fused-valid step on the padded canvas,
  and `num_iter` of them in one cooperative launch.

Two Pallas functions have a plain version here and no wrapper of their
own, because a kernel above computes their function: the full-extent
padded steps `_diffuse_hcw_kernel` (fp32, [B, Hp, C, Wp]; plain version
`par_diffuse_padded_hcw_reference`), which is `par_diffuse`'s step on
unpadded masks (clamped reads of an unpadded mask are what an edge-padded
canvas holds), and `_diffuse_padded_kernel` (bf16; plain version
`par_diffuse_padded_reference`), which is the fused-valid step with full
extents. The paths call those kernels; the plain versions and the padding
helpers `pad_for_diffuse` and `pad_for_diffuse_hcw` are for holding the
kernels against the Pallas functions' own arithmetic (the tests,
chip_smoke.py).

All are bound by device memory; the sources say how. The plain versions
take fp32 and bf16 and follow the Pallas kernels' arithmetic (products
rounded to the storage type, sums in fp32 in chunks of 8 offsets); the
kernels take the types the paths run: the unpadded step and pad-clamp
fp32 and bf16, the affinity with a bf16 output, the fused-valid diffusion
in bf16.

On CPU tensors a wrapper computes its plain version; on CUDA tensors it
launches its kernel or raises. Each wrapper counts its kernel launches in
its `launches` attribute. The slice-2 wrappers take the offsets as (dy, dx)
pairs on the host, as the JAX functions do, so that they read their pad
without waiting for the device; the kernels' [K, 2] device copy is made
once per configuration (`offsets_tensor`). The affinity kernel takes a host
copy instead, and its position terms too: its entry point passes them as
kernel parameters.
"""
from __future__ import annotations

import collections
import functools

import torch
import torch.nn.functional as F

from .. import build

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_CHUNK = 8      # offsets per fp32 partial sum, as in the Pallas kernels
# the most offsets and the largest pad that the fused-valid step and the
# resident diffusion take on the card (csrc/par_diffuse_valid.cu)
PADDED_MAX_OFFSETS = 128
PADDED_MAX_PAD = 64


def offsets_tensor(offsets, device) -> torch.Tensor:
    """[(dy, dx), ...] -> the [K, 2] int32 tensor the kernels take, made
    once per (offsets, device) and shared: callers must not write to it."""
    return _offsets_on(tuple((int(dy), int(dx)) for dy, dx in offsets),
                       torch.device(device))


# id of a tensor made by `offsets_tensor` -> its (dy, dx) pairs, so that a
# launch sizes its halo without reading the device copy; the cached tensors
# live as long as the process, so their ids are never reused
_HOST_OFFSETS: dict[int, tuple] = {}


@functools.lru_cache(maxsize=None)
def _offsets_on(offsets: tuple, device: torch.device) -> torch.Tensor:
    t = torch.tensor(offsets, dtype=torch.int32, device=device).reshape(-1, 2)
    _HOST_OFFSETS[id(t)] = offsets
    return t


def _host_offsets(offsets: torch.Tensor) -> tuple:
    """The (dy, dx) pairs of a [K, 2] offsets tensor: the host copy where
    `offsets_tensor` made it, else read from the tensor (a device read)."""
    pairs = _HOST_OFFSETS.get(id(offsets))
    if pairs is None:
        pairs = tuple(map(tuple, offsets.tolist()))
    return pairs


# csrc/par_diffuse.cu's geometry: tiles of 32 x 64 pixels, a pass of at
# most 8 channels, the shared memory of a block (H100: 227 KiB)
_TILE_H, _TILE_W, _MAX_PASS, _SMEM = 32, 64, 8, 232448


@functools.lru_cache(maxsize=None)
def staged_pad(offsets: tuple, c: int, elem_bytes: int) -> int:
    """The pad of the halo that `par_diffuse`'s kernel stages in shared
    memory for C channels of `elem_bytes`-byte elements: chunks of 8
    offsets that reach beyond it read their neighbours from global memory.
    A larger halo holds fewer channels, so the affinities are read in more
    channel passes; for fp32 this picks the pad (one of the chunks'
    reaches) with the fewest bytes a pixel and channel: the affinities once
    a pass, the staged halo, and one element a far offset (no reuse
    assumed). bf16 stages every offset's reach: its far reads (2-byte
    pairs) cost more than the passes they save (PERF.md)."""
    k = len(offsets)
    reach = [max(max(abs(dy), abs(dx)) for dy, dx in offsets[q:q + _CHUNK])
             for q in range(0, k, _CHUNK)]
    if elem_bytes == 2:
        return max(reach)
    per = 16 // elem_bytes
    table = -(-(k + len(reach)) // 4) * 16
    best = None
    for pad in sorted(set(reach)):
        pad_cols = -(-pad // per) * per
        plane = ((_TILE_H + 2 * pad) * (_TILE_W + 2 * pad_cols)
                 * elem_bytes)
        nc = min(_MAX_PASS, (_SMEM - table) // plane)
        if nc < 1:
            break
        passes = -(-c // nc)
        far = sum(min(_CHUNK, k - _CHUNK * q) for q, r in enumerate(reach)
                  if r > pad)
        cost = (k * elem_bytes * passes / c
                + plane / (_TILE_H * _TILE_W) + far * elem_bytes)
        if best is None or cost < best[0]:
            best = (cost, pad)
    if best is None:
        raise NotImplementedError(f"par_diffuse: no halo of these offsets "
                                  f"fits shared memory (reaches {reach})")
    return best[1]


def par_diffuse_reference(masks: torch.Tensor, aff: torch.Tensor,
                          offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of `par_diffuse`: edge-pad, then one shifted product per
    offset. fp32: summed in offset order. bf16: the Pallas kernel's rounding
    points: each product rounded to bf16, the products of a chunk of 8
    offsets summed in fp32 in offset order, each chunk's sum rounded to
    bf16 and added onto the bf16 output (one more rounding a chunk)."""
    _, _, h, w = masks.shape
    offs = offsets.tolist()
    pad = max(max(abs(dy), abs(dx)) for dy, dx in offs)
    mp = F.pad(masks.float(), (pad, pad, pad, pad),
               mode="replicate").to(masks.dtype)

    def product(i):
        dy, dx = offs[i]
        return (mp[:, :, pad + dy:pad + dy + h, pad + dx:pad + dx + w]
                * aff[:, i:i + 1])

    if masks.dtype == torch.float32:
        acc = torch.zeros_like(masks)
        for i in range(len(offs)):
            acc = acc + product(i)
        return acc
    acc = None
    for c0 in range(0, len(offs), _CHUNK):
        part = None
        for i in range(c0, min(c0 + _CHUNK, len(offs))):
            term = product(i).float()
            part = term if part is None else part + term
        part = part.to(masks.dtype)
        acc = part if acc is None else acc + part
    return acc


def par_diffuse(masks: torch.Tensor, aff: torch.Tensor,
                offsets: torch.Tensor) -> torch.Tensor:
    """masks: [B, C, H, W], aff: [B, K, H, W], both float32 or both
    bfloat16; offsets: [K, 2] int32 (dy, dx) on the same device, all
    contiguous; any K >= 1 and C >= 1. Returns the diffused [B, C, H, W]
    masks in the inputs' type (bf16: the roundings of
    `par_diffuse_reference`). On the card the kernel stages a halo of
    `staged_pad` rows and columns, from the host copy of the offsets that
    `offsets_tensor` keeps (another tensor is read once, a device read);
    a bf16 pad whose halo of one channel does not fit shared memory
    raises."""
    if masks.dim() != 4 or aff.dim() != 4:
        raise ValueError("masks and aff must be [B, C, H, W] / [B, K, H, W]")
    b, c, h, w = masks.shape
    k = aff.shape[1]
    if (aff.shape != (b, k, h, w) or offsets.shape != (k, 2)
            or min(b, c, h, w, k) < 1):
        raise ValueError(f"shape mismatch: masks {tuple(masks.shape)}, aff "
                         f"{tuple(aff.shape)}, offsets {tuple(offsets.shape)}")
    if masks.dtype not in _SUFFIX:
        raise NotImplementedError(f"par_diffuse: masks are {masks.dtype}; "
                                  "the kernel takes float32 and bfloat16")
    if aff.dtype != masks.dtype:
        raise ValueError("par_diffuse: masks and aff must share a dtype")
    if offsets.dtype != torch.int32:
        raise ValueError("offsets must be int32")
    for t in (aff, offsets):
        if t.device != masks.device:
            raise ValueError("masks, aff and offsets must be on one device")
    if not (masks.is_contiguous() and aff.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError("masks, aff and offsets must be contiguous")
    if masks.device.type == "cpu":
        return par_diffuse_reference(masks, aff, offsets)
    if masks.device.type != "cuda":
        raise ValueError(f"unsupported device {masks.device}")
    out = torch.empty_like(masks)
    fn = build.load("par_diffuse",
                    f"excel_par_diffuse_{_SUFFIX[masks.dtype]}")
    pairs = _host_offsets(offsets)
    build.check(fn(masks.data_ptr(), aff.data_ptr(), offsets.data_ptr(),
                   out.data_ptr(), b, c, h, w, k,
                   staged_pad(pairs, c, masks.element_size()),
                   _pad_of(pairs), _stream(masks)), "par_diffuse")
    par_diffuse.launches += 1
    par_diffuse.launches_by_type[masks.dtype, k] += 1
    return out


par_diffuse.launches = 0
# the same launches by (dtype, K): PAR's 48 offsets apart from the CRF's 72
par_diffuse.launches_by_type = collections.Counter()


# ---------------------------------------------------------------------------
# shared checks and the clamped gather
# ---------------------------------------------------------------------------

def padded_shape(h: int, w: int, pad: int) -> tuple[int, int]:
    """(Hp, Wp) of a padded PAR canvas: 8 slack rows, lanes to 128."""
    return h + 2 * pad + 8, -(-(w + 2 * pad) // 128) * 128


def _pad_of(offsets) -> int:
    return max(max(abs(dy), abs(dx)) for dy, dx in offsets)


def _check(name: str, tensors: dict, device, dtypes=tuple(_SUFFIX)) -> None:
    for key, x in tensors.items():
        if x.device != device:
            raise ValueError(f"{name}: {key} is on {x.device}, not {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if key == "valid_hw":
            if x.dtype != torch.int32:
                raise ValueError(f"{name}: {key} must be int32")
        elif x.dtype not in dtypes:
            raise NotImplementedError(
                f"{name}: {key} is {x.dtype}; the kernel takes "
                f"{', '.join(str(d) for d in dtypes)}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")


def _clamped_gather(x: torch.Tensor, valid_hw: torch.Tensor, pad: int,
                    hp: int, wp: int) -> torch.Tensor:
    """out[b, c, Y, X] = x[b, c, clamp(Y - pad, 0, vh - 1),
    clamp(X - pad, 0, vw - 1)] over a [hp, wp] canvas."""
    b, c, h, w = x.shape
    vh = valid_hw[:, 0:1].long().clamp(1, h)
    vw = valid_hw[:, 1:2].long().clamp(1, w)
    rows = torch.minimum((torch.arange(hp, device=x.device) - pad)
                         .clamp(min=0)[None], vh - 1)
    cols = torch.minimum((torch.arange(wp, device=x.device) - pad)
                         .clamp(min=0)[None], vw - 1)
    x = torch.gather(x, 2, rows[:, None, :, None].expand(b, c, hp, w))
    return torch.gather(x, 3, cols[:, None, None, :].expand(b, c, hp, wp))


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# fused valid-extent clamp + edge pad
# ---------------------------------------------------------------------------

def pad_replicate_valid_reference(x: torch.Tensor, valid_hw: torch.Tensor,
                                  pad: int) -> torch.Tensor:
    """Plain version of `pad_replicate_valid`."""
    return _clamped_gather(x, valid_hw, pad, *padded_shape(*x.shape[2:], pad))


def pad_replicate_valid(x: torch.Tensor, valid_hw: torch.Tensor,
                        pad: int) -> torch.Tensor:
    """Fused `pad_for_diffuse(_replicate_valid(x, valid_hw), pad)`.

    x: [B, C, H, W] float32 or bfloat16; valid_hw: [B, 2] int32 (h, w) of
    each image, anchored top-left. Returns [B, C, H + 2P + 8,
    roundup128(W + 2P)] where every position holds the value of its clamped
    valid source pixel, the alignment slack included (as the Pallas
    kernel's output)."""
    if x.dim() != 4 or valid_hw.shape != (x.shape[0], 2) or pad < 0:
        raise ValueError(f"pad_replicate_valid: x {tuple(x.shape)}, "
                         f"valid_hw {tuple(valid_hw.shape)}, pad {pad}")
    _check("pad_replicate_valid", {"x": x, "valid_hw": valid_hw}, x.device)
    if x.device.type == "cpu":
        return pad_replicate_valid_reference(x, valid_hw, pad)
    b, c, h, w = x.shape
    out = x.new_empty((b, c, *padded_shape(h, w, pad)))
    fn = build.load("par_pad_clamp", f"excel_pad_clamp_{_SUFFIX[x.dtype]}")
    build.check(fn(x.data_ptr(), valid_hw.data_ptr(), out.data_ptr(), b, c, h,
                   w, pad, _stream(x)), "par_pad_clamp")
    pad_replicate_valid.launches += 1
    return out


pad_replicate_valid.launches = 0


# ---------------------------------------------------------------------------
# appearance affinity
# ---------------------------------------------------------------------------

# csrc/par_affinity.cu's geometry: tiles of 32, 16 or 8 rows x 64 columns
# whose haloed slab of 3 fp32 channels is staged in shared memory, a slab
# row padded to 4 words, channel planes 9,216 floats apart (two blocks an
# SM) or 19,328 (one block)
_AFF_TW, _AFF_ROWS, _AFF_PLANES = 64, (32, 16, 8), (9216, 19328)


def affinity_slab_words(tile_rows: int, pad: int) -> int:
    """Words of one channel of a `par_affinity` slab: a tile's rows and 64
    columns with a halo of `pad`, each row padded to 4 words."""
    return (tile_rows + 2 * pad) * (-(-(_AFF_TW + 2 * pad) // 4) * 4)


def affinity_tiling(pad: int) -> tuple[int, int]:
    """(tile rows, words between channel planes) of `par_affinity`'s kernel
    at this pad, as the kernel picks them: the most rows of 32, 16, 8 whose
    slab fits the small plane (two blocks an SM), else the large one;
    (0, 0) for a pad the slab kernel does not take (above 52)."""
    for plane in _AFF_PLANES:
        for rows in _AFF_ROWS:
            if affinity_slab_words(rows, pad) <= plane:
                return rows, plane
    return 0, 0


# the most offsets of the slab kernel (its logits live in registers) and of
# the direct kernel (a local array)
AFFINITY_SLAB_MAX_OFFSETS = 64
AFFINITY_MAX_OFFSETS = 128


def affinity_kernel(pad: int, k: int) -> str:
    """The kernel `par_affinity` launches for a pad and K offsets: "slab"
    where its slab fits shared memory (`affinity_tiling`) and K <= 64,
    else "direct" (csrc/par_affinity.cu: neighbours read through L1/L2,
    the same arithmetic)."""
    if affinity_tiling(pad)[0] and k <= AFFINITY_SLAB_MAX_OFFSETS:
        return "slab"
    return "direct"


def position_terms(pos_w, w2: float, device) -> torch.Tensor:
    """[K] fp32 w2 * pos_w[k], each product taken in double and rounded once
    (the Pallas kernel's Python-float constant); made once per (pos_w, w2,
    device) and shared: callers must not write to it."""
    return _position_terms_on(tuple(float(p) for p in pos_w), float(w2),
                              torch.device(device))


@functools.lru_cache(maxsize=None)
def _position_terms_on(pos_w: tuple, w2: float,
                       device: torch.device) -> torch.Tensor:
    return torch.tensor([w2 * p for p in pos_w], dtype=torch.float32,
                        device=device)


def par_affinity_reference(img_padded: torch.Tensor, offsets, pos_w, h: int,
                           w: int, w1: float = 0.3, w2: float = 0.01,
                           out_dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """Plain version of `par_affinity`, in the kernel's order of rounding."""
    offs = list(offsets)
    k = len(offs)
    pad = _pad_of(offsets)

    def shifted(dy, dx):
        return img_padded[:, :, pad + dy:pad + dy + h, pad + dx:pad + dx + w]

    centre = shifted(0, 0)
    s1 = s2 = None
    for c0 in range(0, k, _CHUNK):
        p1 = p2 = None
        for dy, dx in offs[c0:c0 + _CHUNK]:
            n = shifted(dy, dx)
            p1 = n if p1 is None else p1 + n
            p2 = n * n if p2 is None else p2 + n * n
        s1 = p1 if s1 is None else s1 + p1
        s2 = p2 if s2 is None else s2 + p2
    kf = float(k)
    mean = s1 / kf
    var = torch.clamp(s2 / kf - mean * mean, min=0.0) * (kf / (kf - 1.0))
    inv = 1.0 / ((torch.sqrt(var) + 1e-8) * w1)
    logits = []
    for dy, dx in offs:
        d = (shifted(dy, dx) - centre) * inv
        dd = d * d
        logits.append(-((dd[:, 0] + dd[:, 1]) + dd[:, 2]) / 3.0)
    logits = torch.stack(logits, dim=1)                    # [B, K, h, w]
    e = torch.exp(logits - logits.amax(dim=1, keepdim=True))
    total = e[:, 0]
    for i in range(1, k):
        total = total + e[:, i]
    pos = position_terms(pos_w, w2, img_padded.device)
    return (e * (1.0 / total)[:, None]
            + pos[None, :, None, None]).to(out_dtype)


def par_affinity(img_padded: torch.Tensor, offsets, pos_w, h: int, w: int,
                 w1: float = 0.3, w2: float = 0.01,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """PAR affinity from a padded image.

    img_padded: [B, 3, Hp, Wp] float32 with the image at [P, P + h) x
    [P, P + w) and edge-replicated around it (P = max |offset|, Hp >= h + 2P,
    Wp >= w + 2P); offsets: the K (dy, dx) pairs, K a multiple of 8 up to
    128; pos_w: the K position weights. Returns aff [B, K, h, w] in
    out_dtype: bfloat16 (or float32 on the CPU). On the card the slab
    kernel runs where it takes the pad and K, the direct kernel elsewhere
    (`affinity_kernel`; `launches_by_kernel` counts each); both take the
    offsets and the position terms from host memory, as kernel
    parameters."""
    if img_padded.dim() != 4 or img_padded.shape[1] != 3:
        raise ValueError(f"par_affinity: img_padded must be [B, 3, Hp, Wp], "
                         f"got {tuple(img_padded.shape)}")
    k = len(offsets)
    pad = _pad_of(offsets)
    b, _, hp, wp = img_padded.shape
    if (len(pos_w) != k or k % 8 or not
            0 < k <= AFFINITY_MAX_OFFSETS or hp < h + 2 * pad
            or wp < w + 2 * pad):
        raise ValueError(f"par_affinity: img_padded {tuple(img_padded.shape)}"
                         f", {k} offsets, {len(pos_w)} "
                         f"position weights, h={h} w={w}")
    if out_dtype not in _SUFFIX:
        raise NotImplementedError(f"par_affinity: out_dtype {out_dtype}")
    _check("par_affinity", {"img_padded": img_padded}, img_padded.device,
           dtypes=(torch.float32,))
    if img_padded.device.type == "cpu":
        return par_affinity_reference(img_padded, offsets, pos_w, h, w, w1,
                                      w2, out_dtype)
    if out_dtype != torch.bfloat16:
        raise NotImplementedError("par_affinity: the kernel writes bf16 "
                                  "affinities (the fast preset's)")
    kernel = affinity_kernel(pad, k)
    out = img_padded.new_empty((b, k, h, w), dtype=out_dtype)
    wpos = position_terms(pos_w, w2, "cpu")
    offsets_t = offsets_tensor(offsets, "cpu")
    fn = build.load("par_affinity", "excel_par_affinity_bf16"
                    if kernel == "slab" else "excel_par_affinity_direct_bf16")
    build.check(fn(img_padded.data_ptr(), offsets_t.data_ptr(),
                   wpos.data_ptr(), out.data_ptr(), b, h, w, hp, wp, k, pad,
                   w1, _stream(img_padded)), f"par_affinity ({kernel})")
    par_affinity.launches += 1
    par_affinity.launches_by_kernel[kernel] += 1
    return out


par_affinity.launches = 0
par_affinity.launches_by_kernel = collections.Counter()


# ---------------------------------------------------------------------------
# padded diffusion steps: full extent (plain versions) and fused-valid
# ---------------------------------------------------------------------------

def _chunk_sums(mp: torch.Tensor, aff: torch.Tensor, offs: list, pad: int,
                h: int, w: int) -> torch.Tensor:
    """The Pallas steps' sums over a padded [B, C, Hp, Wp] canvas: each
    product rounded to the storage type, summed in fp32 within chunks of 8
    offsets and chunk by chunk. Returns [B, C, h, w] fp32."""
    acc = None
    for c0 in range(0, len(offs), _CHUNK):
        part = None
        for i in range(c0, min(c0 + _CHUNK, len(offs))):
            dy, dx = offs[i]
            m = mp[:, :, pad + dy:pad + dy + h, pad + dx:pad + dx + w]
            term = (aff[:, i:i + 1] * m).float()
            part = term if part is None else part + term
        acc = part if acc is None else acc + part
    return acc


def _edge_pad_to(x: torch.Tensor, pad: int, hp: int,
                 wp: int) -> torch.Tensor:
    """[B, C, h, w] -> [B, C, hp, wp]: position (Y, X) takes
    x[clamp(Y - pad), clamp(X - pad)] (the padded steps' replicated
    border, slack rows and columns included)."""
    h, w = x.shape[-2:]
    rows = (torch.arange(hp, device=x.device) - pad).clamp(0, h - 1)
    cols = (torch.arange(wp, device=x.device) - pad).clamp(0, w - 1)
    return x[:, :, rows][:, :, :, cols]


def pad_for_diffuse(m: torch.Tensor, pad: int) -> torch.Tensor:
    """The Pallas `pad_for_diffuse` layout: [B, C, H, W] -> edge-padded
    [B, C, H + 2P + 8, roundup128(W + 2P)] with zero slack."""
    mp = F.pad(m.float(), (pad, pad, pad, pad), mode="replicate").to(m.dtype)
    return F.pad(mp, (0, (-mp.shape[-1]) % 128, 0, 8))


def pad_for_diffuse_hcw(m: torch.Tensor, pad: int) -> torch.Tensor:
    """The Pallas `pad_for_diffuse_hcw` layout, fp32: [B, C, H, W] ->
    edge-padded [B, H + 2P, roundup8(C), roundup128(W + 2P)] with zero
    channel and lane slack."""
    mp = F.pad(m.float(), (pad, pad, pad, pad), mode="replicate")
    mp = F.pad(mp, (0, (-mp.shape[-1]) % 128, 0, 0, 0, (-mp.shape[1]) % 8))
    return mp.permute(0, 2, 1, 3).contiguous()


def par_diffuse_padded_hcw_reference(masks_padded: torch.Tensor,
                                     aff: torch.Tensor, offsets, h: int,
                                     w: int) -> torch.Tensor:
    """Plain version of the Pallas `par_diffuse_padded_hcw` step (fp32):
    masks_padded [B, h + 2P, C8, Wp] (`pad_for_diffuse_hcw`), aff
    [B, K, h, w]; returns the next canvas, the border replicated."""
    offs, pad = list(offsets), _pad_of(offsets)
    _, hp, _, wp = masks_padded.shape
    if hp != h + 2 * pad or wp < w + 2 * pad or aff.shape[1] != len(offs):
        raise ValueError(f"par_diffuse_padded_hcw_reference: masks_padded "
                         f"{tuple(masks_padded.shape)}, aff "
                         f"{tuple(aff.shape)}, h={h} w={w}")
    acc = _chunk_sums(masks_padded.permute(0, 2, 1, 3), aff, offs, pad, h, w)
    return _edge_pad_to(acc, pad, hp, wp).permute(0, 2, 1, 3).contiguous()


def par_diffuse_padded_reference(masks_padded: torch.Tensor,
                                 aff: torch.Tensor, offsets, h: int,
                                 w: int) -> torch.Tensor:
    """Plain version of the Pallas `par_diffuse_padded` step: masks_padded
    [B, C, h + 2P + 8, Wp] (`pad_for_diffuse`; bf16 or fp32), aff
    [B, K, h, w] of the same type; products in that type, fp32 sums in
    chunks of 8, the result rounded to it and its border replicated over
    the whole canvas."""
    offs, pad = list(offsets), _pad_of(offsets)
    _, _, hp, wp = masks_padded.shape
    if (hp != h + 2 * pad + 8 or wp < w + 2 * pad or pad % 8
            or aff.shape[1] != len(offs)):
        raise ValueError(f"par_diffuse_padded_reference: masks_padded "
                         f"{tuple(masks_padded.shape)}, aff "
                         f"{tuple(aff.shape)}, pad {pad}, h={h} w={w}")
    acc = _chunk_sums(masks_padded, aff, offs, pad, h, w)
    return _edge_pad_to(acc.to(masks_padded.dtype), pad, hp, wp)


def _valid_step_reference(mp: torch.Tensor, aff: torch.Tensor,
                          valid_hw: torch.Tensor, offs: list, pad: int,
                          h: int, w: int) -> torch.Tensor:
    """One fused-valid step: the chunked sums, then every canvas position
    takes its clamped valid source pixel's sum."""
    acc = _chunk_sums(mp, aff, offs, pad, h, w)
    return _clamped_gather(acc, valid_hw, pad, *mp.shape[2:]).to(mp.dtype)


def par_diffuse_padded_valid_reference(masks_padded, aff, valid_hw, offsets,
                                       h: int, w: int) -> torch.Tensor:
    """Plain version of `par_diffuse_padded_valid`."""
    return _valid_step_reference(masks_padded, aff, valid_hw, list(offsets),
                                 _pad_of(offsets), h, w)


def par_diffuse_valid_resident_reference(masks_padded, aff, valid_hw,
                                         offsets, h: int, w: int,
                                         num_iter: int) -> torch.Tensor:
    """Plain version of `par_diffuse_valid_resident`: `num_iter` steps."""
    offs, pad = list(offsets), _pad_of(offsets)
    m = masks_padded
    for _ in range(num_iter):
        m = _valid_step_reference(m, aff, valid_hw, offs, pad, h, w)
    return m


def _check_valid_step(name, masks_padded, aff, valid_hw, offsets, h, w):
    if masks_padded.dim() != 4 or aff.dim() != 4:
        raise ValueError(f"{name}: masks_padded and aff must be 4-D")
    b, c, hp, wp = masks_padded.shape
    k = len(offsets)
    pad = _pad_of(offsets)
    if (aff.shape != (b, k, h, w) or valid_hw.shape != (b, 2)
            or hp < h + 2 * pad
            or wp < w + 2 * pad):
        raise ValueError(f"{name}: masks_padded {tuple(masks_padded.shape)},"
                         f" aff {tuple(aff.shape)}, valid_hw "
                         f"{tuple(valid_hw.shape)}, {k} offsets, h={h} "
                         f"w={w}")
    if aff.dtype != masks_padded.dtype:
        raise ValueError(f"{name}: aff and masks_padded must share a dtype")
    _check(name, {"masks_padded": masks_padded, "aff": aff,
                  "valid_hw": valid_hw}, masks_padded.device)
    if masks_padded.device.type == "cuda" and (
            masks_padded.dtype != torch.bfloat16 or k > PADDED_MAX_OFFSETS
            or pad > PADDED_MAX_PAD):
        raise NotImplementedError(f"{name}: the kernel takes bf16 canvases "
                                  f"(the fast preset's), at most "
                                  f"{PADDED_MAX_OFFSETS} offsets and a pad of "
                                  f"at most {PADDED_MAX_PAD} (got "
                                  f"{masks_padded.dtype}, K={k}, pad {pad})")
    return b, c, hp, wp, k, pad


def par_diffuse_padded_valid(masks_padded: torch.Tensor, aff: torch.Tensor,
                             valid_hw: torch.Tensor, offsets, h: int,
                             w: int) -> torch.Tensor:
    """One padded diffusion step with the valid-extent clamp fused in.

    masks_padded: [B, C, Hp, Wp] replicate-valid canvas (from
    `pad_replicate_valid`), bfloat16 (or float32 on the CPU); aff:
    [B, K, h, w] of the same type; valid_hw: [B, 2] int32; offsets: the K
    (dy, dx) pairs. Returns the next canvas, same shape and type."""
    b, c, hp, wp, k, pad = _check_valid_step(
        "par_diffuse_padded_valid", masks_padded, aff, valid_hw, offsets, h,
        w)
    if masks_padded.device.type == "cpu":
        return par_diffuse_padded_valid_reference(masks_padded, aff, valid_hw,
                                                  offsets, h, w)
    out = torch.empty_like(masks_padded)
    offsets_t = offsets_tensor(offsets, masks_padded.device)
    fn = build.load("par_diffuse_valid", "excel_par_diffuse_valid_step_bf16")
    build.check(fn(masks_padded.data_ptr(), aff.data_ptr(),
                   valid_hw.data_ptr(), offsets_t.data_ptr(), out.data_ptr(),
                   b, c, h, w, hp, wp, k, pad, _stream(masks_padded)),
                "par_diffuse_padded_valid")
    par_diffuse_padded_valid.launches += 1
    return out


par_diffuse_padded_valid.launches = 0


def par_diffuse_valid_resident(masks_padded: torch.Tensor, aff: torch.Tensor,
                               valid_hw: torch.Tensor, offsets, h: int, w: int,
                               num_iter: int) -> torch.Tensor:
    """`num_iter` >= 1 steps of `par_diffuse_padded_valid` in one launch (a
    cooperative kernel with a grid barrier between steps); the same bits as
    iterating the step. Same arguments and result shape."""
    b, c, hp, wp, k, pad = _check_valid_step(
        "par_diffuse_valid_resident", masks_padded, aff, valid_hw, offsets, h,
        w)
    if num_iter < 1:
        raise ValueError(f"par_diffuse_valid_resident: num_iter {num_iter}")
    if masks_padded.device.type == "cpu":
        return par_diffuse_valid_resident_reference(
            masks_padded, aff, valid_hw, offsets, h, w, num_iter)
    out = torch.empty_like(masks_padded)
    scratch = torch.empty_like(masks_padded) if num_iter > 1 else out
    offsets_t = offsets_tensor(offsets, masks_padded.device)
    fn = build.load("par_diffuse_valid",
                    "excel_par_diffuse_valid_resident_bf16")
    build.check(fn(masks_padded.data_ptr(), aff.data_ptr(),
                   valid_hw.data_ptr(), offsets_t.data_ptr(), out.data_ptr(),
                   scratch.data_ptr(), b, c, h, w, hp, wp, k, pad, num_iter,
                   _stream(masks_padded)), "par_diffuse_valid_resident")
    par_diffuse_valid_resident.launches += 1
    return out


par_diffuse_valid_resident.launches = 0
