"""conv3x3: the VAE's 3×3 convolution in NHWC, with its bias and ELU.

The kernels are `csrc/conv3x3.cu` (see the note at the top of that file):
an implicit GEMM in split TF32 on the tensor cores for the forward pass
(bias and ELU in its epilogue) and the data gradient, a second one for the
weight and bias gradients, summed over pixel chunks in a fixed order. They
replace no TPU kernel; they take the place of cuDNN's float32 convolutions,
which wanted NCHW and ran off the tensor cores.

`conv3x3(x, weight, bias, stride, pads, elu)` takes x as NHWC (N, H, W, Cin),
the weight as nn.Conv2d keeps it (OIHW), `pads` = (top, bottom, left, right)
zero padding, and returns ELU(conv + bias) (or conv + bias) as NHWC, on the
kernels: float32 CUDA tensors, anything else raises by name. The plain
version is `conv3x3_torch` (F.conv2d on the NCHW view, F.elu); the caller
picks between them by device and dtype (models/vae.py `_conv3x3`).

The plans (`fprop_plan`, `dgrad_plan`, `wgrad_plan`) are plain functions of
the shape and the pointers' alignment; the card's occupancy and SM count
size the grids, and a layer's plans are cached per device and shape
(`_layer`). Each direction is one helper and one ctypes call: `fprop`, and
`grads`, a layer's whole backward: g = dY · ELU′ from the saved output y
(1 where y > 0, else y + 1) in one elementwise pass, then dX (skipped where
x needs no gradient) and dW, db from g. Eager calls reach them through the
autograd.Function `Conv3x3`; torch.export and torch.compile through the
custom operators gppvae::conv3x3 and gppvae::conv3x3_backward, so that an
exported program runs the kernels too. The timings (utils/kernel_timing.py)
call the same two helpers. The launches are counted per pass in the
tracer's counters `launch_conv3x3.fprop`, `.dgrad`, `.wgrad`.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field, replace

import torch
import torch.nn.functional as F

from gppvae_tpu_torch.ops import _build
from gppvae_tpu_torch.ops.factor_prep import _on, _stream
from gppvae_tpu_torch.utils.timers import count

# csrc/conv3x3.cu's shape: persistent CTAs of four warps walk tiles of BM =
# 128 output pixels by 8·nt output channels (nt 1, 2, 4 or 8), each CTA's
# weights resident in shared memory, the source's K in stages of 32 through a
# ring of three; the weight gradient's CTA takes 8·nt output channels by bpc
# column blocks of 32 (column J = tap·Cin + ci, and one of ones for db), kw
# warps on each.
BM = 128
KS = 32
LDK = KS + 4
STAGES = 3
NTS = (1, 2, 4, 8)
WGRAD_NTS = (1, 2, 4)
WGRAD_MAX_WARPS = 8
MAX_CLASSES = 4
SMEM_MOST = 232448 - 4096  # an H100 block's shared memory, less the static arrays
# the weight gradient's pixel chunks: about this many warps per SM in all
WGRAD_WARPS_PER_SM = 16
PASSES = ("fprop", "dgrad", "wgrad")
COUNTERS = tuple(f"launch_conv3x3.{p}" for p in PASSES)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def out_size(size: int, stride: int, lo: int, hi: int) -> int:
    """Output length of one axis: 3 taps, `stride`, `lo` + `hi` padding."""
    return (size + lo + hi - 3) // stride + 1


def fast_div(d: int) -> tuple[int, int, int]:
    """csrc FastDiv (d, mul, shr): n // d == ((n · mul) >> 32) + n) >> shr
    for 0 <= n < 2³¹, mul as a signed 32-bit int."""
    shr = (d - 1).bit_length()
    mul = (1 << 32) * ((1 << shr) - d) // d + 1
    return d, mul - (1 << 32) if mul >= 1 << 31 else mul, shr


def conv3x3_torch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                  stride: int = 1, pads=(1, 1, 1, 1), elu: bool = False) -> torch.Tensor:
    """Plain version: F.conv2d on the NCHW view of x (F.pad first where the
    padding differs between sides), then F.elu; NHWC out. Counts its calls
    in `conv3x3_torch.calls` and those on a CUDA tensor in
    `conv3x3_torch.cuda_calls`."""
    count("conv3x3_torch.calls")
    if x.is_cuda:
        count("conv3x3_torch.cuda_calls")
    h = x.permute(0, 3, 1, 2)
    pt, pb, pl, pr = pads
    if pt == pb == pl == pr:
        y = F.conv2d(h, weight, bias, stride, pt)
    else:
        y = F.conv2d(F.pad(h, (pl, pr, pt, pb)), weight, bias, stride)
    if elu:
        y = F.elu(y)
    return y.permute(0, 2, 3, 1)


# ---- plans


def _axis(taps) -> list[int]:
    """csrc Axis: n, w[3], off[3] of [(weight index, input offset), …]."""
    w = [r for r, _ in taps] + [0] * (3 - len(taps))
    off = [o for _, o in taps] + [0] * (3 - len(taps))
    return [len(taps), *w, *off]


@dataclass(frozen=True)
class Class:
    """The output pixels of one class: a gh × gw grid at (oy·ostep + oy0,
    ox·ostep + ox0), input coordinate o·istep + off per tap, and the taps
    [(weight index, offset)] of each axis."""
    gh: int
    gw: int
    oy0: int
    ox0: int
    ostep: int
    istep: int
    rows: tuple
    cols: tuple

    def k(self, cg: int) -> int:
        return len(self.rows) * len(self.cols) * cg

    def tiles(self, batch: int) -> int:
        return _cdiv(batch * self.gh * self.gw, BM)


def ldw(k: int) -> int:
    """A class's weight row in shared memory: K rounded up to whole stages,
    and 4 (4 mod 32, so that the fragments' loads hit 32 banks)."""
    return _cdiv(k, KS) * KS + 4


@dataclass(frozen=True)
class GemmPlan:
    """One fprop or dgrad launch (csrc GemmPlan): the source NHWC (batch,
    ih, iw, cg), the output NHWC (batch, oh, ow, cn), the weight of output
    channel n and source channel c at w[n·sn + c·sc + 3r + s]; the tile's
    8·nt channels, 16-byte copies (vec), ELU in the epilogue, the classes,
    and grid_m persistent CTAs by grid_n channel tiles (`with_grid`)."""
    batch: int
    ih: int
    iw: int
    cg: int
    oh: int
    ow: int
    cn: int
    sn: int
    sc: int
    nt: int
    vec: bool
    elu: bool
    classes: tuple
    grid_m: int = 1
    c_ints: object = field(default=None, compare=False, repr=False)

    @property
    def tiles(self) -> int:
        return sum(c.tiles(self.batch) for c in self.classes)

    @property
    def wfloats(self) -> int:
        """Floats of the classes' weights in shared memory."""
        return 8 * self.nt * sum(ldw(c.k(self.cg)) for c in self.classes)

    @property
    def smem(self) -> int:
        return 4 * (self.wfloats + STAGES * BM * LDK)

    @property
    def grid_n(self) -> int:
        return _cdiv(self.cn, 8 * self.nt)

    def ints(self) -> list[int]:
        cls, woff, tile0 = [], 0, 0
        for c in self.classes:
            k = c.k(self.cg)
            cls += [c.gh, c.gw, c.oy0, c.ox0, c.ostep, c.istep, *_axis(c.rows), *_axis(c.cols),
                    *fast_div(c.gw), *fast_div(c.gh), k, ldw(k), woff, c.tiles(self.batch),
                    tile0]
            woff += 8 * self.nt * ldw(k)
            tile0 += c.tiles(self.batch)
        cls += [0] * (31 * MAX_CLASSES - len(cls))
        return [self.batch, self.ih, self.iw, self.cg, self.oh, self.ow, self.cn, self.sn,
                self.sc, self.nt, int(self.vec), int(self.elu), self.smem, len(self.classes),
                self.grid_m, self.grid_n, self.tiles, self.wfloats, *cls]

    def with_grid(self, resident: int) -> "GemmPlan":
        """The plan with grid_m = the tiles, at most `resident` CTAs (those
        the card holds at once), and its ints for the C entry."""
        plan = replace(self, grid_m=max(1, min(self.tiles, resident)))
        return _with_ints(plan)


def _with_ints(plan):
    ints = plan.ints()
    object.__setattr__(plan, "c_ints", (ctypes.c_int * len(ints))(*ints))
    return plan


def tile_nt(cn: int, classes=(), cg: int = 0) -> int:
    """The tile's 8-channel blocks: the fewest that hold cn, at most 8, and
    fewer where the classes' weights would not leave the ring its room."""
    nt = next((nt for nt in NTS if 8 * nt >= cn), NTS[-1])
    while nt > 1 and 4 * (8 * nt * sum(ldw(c.k(cg)) for c in classes)
                          + STAGES * BM * LDK) > SMEM_MOST:
        nt //= 2
    return nt


def _gemm_plan(batch, ih, iw, cg, oh, ow, cn, sn, sc, vec, elu, classes) -> GemmPlan:
    nt = tile_nt(cn, classes, cg)
    plan = GemmPlan(batch, ih, iw, cg, oh, ow, cn, sn, sc, nt, vec, elu, tuple(classes))
    if plan.smem > SMEM_MOST:
        raise ValueError(f"conv3x3: {cg} source channels do not fit the kernels' shared memory")
    return plan


def fprop_plan(batch: int, H: int, W: int, cin: int, cout: int, stride: int, pads,
               elu: bool, aligned: bool = True) -> GemmPlan:
    """y = conv(x) + b: M = output pixels, N = cout, K = 9·cin; tap r reads
    input row oy·stride + r − top (grid_m 1: `with_grid` sets it)."""
    pt, pb, pl, pr = pads
    OH, OW = out_size(H, stride, pt, pb), out_size(W, stride, pl, pr)
    cls = Class(OH, OW, 0, 0, 1, stride, tuple((r, r - pt) for r in range(3)),
                tuple((s, s - pl) for s in range(3)))
    return _gemm_plan(batch, H, W, cin, OH, OW, cout, 9 * cin, 9, aligned and cin % 4 == 0,
                      elu, (cls,))


def _dgrad_axis(p: int, pad: int, stride: int) -> tuple:
    """Taps (weight index, offset into g) of output coordinates ≡ p mod
    stride: g's coordinate is (o·stride + p + pad − r) / stride where that
    divides."""
    return tuple((r, (p + pad - r) // stride) for r in range(3) if (p + pad - r) % stride == 0)


def dgrad_plan(batch: int, H: int, W: int, cin: int, cout: int, stride: int, pads,
               aligned: bool = True) -> GemmPlan:
    """dX from g = dY·ELU′ (batch, OH, OW, cout): at stride 1 the conv of g
    with the kernel turned 180° and transposed (M = input pixels, N = cin,
    K = 9·cout); at stride 2 one class per parity of (y, x), each over its
    own taps of g, in one launch."""
    pt, pb, pl, pr = pads
    OH, OW = out_size(H, stride, pt, pb), out_size(W, stride, pl, pr)
    classes = []
    for py in range(stride):
        for px in range(stride):
            gh, gw = _cdiv(H - py, stride), _cdiv(W - px, stride)
            if gh > 0 and gw > 0:
                classes.append(Class(gh, gw, py, px, stride, 1, _dgrad_axis(py, pt, stride),
                                     _dgrad_axis(px, pl, stride)))
    return _gemm_plan(batch, OH, OW, cout, H, W, cin, 9, 9 * cin, aligned and cout % 4 == 0,
                      False, classes)


@dataclass(frozen=True)
class WgradPlan:
    """One wgrad launch (csrc WgradPlan): x NHWC (batch, ih, iw, cin), g
    NHWC (batch, oh, ow, cout); dW's cols = 9·cin + 1 (db's the last). A
    CTA takes 8·nt N-side columns (g's channels) by bpc M-side column
    blocks of 32 (x at each (tap, channel), and the ones), kw warps on each,
    over chunk_px output pixels; the grid chunks × groups × row_tiles. With
    `swap`, K is the input pixels, the M side x's channels and the ones,
    the N side g at each (tap, channel)."""
    batch: int
    ih: int
    iw: int
    cin: int
    oh: int
    ow: int
    cout: int
    stride: int
    pt: int
    pl: int
    nt: int
    bpc: int
    kw: int
    chunks: int
    chunk_px: int
    vec_x: bool
    vec_g: bool
    swap: bool = False
    c_ints: object = field(default=None, compare=False, repr=False)

    @property
    def row_tiles(self) -> int:
        return _cdiv(9 * self.cout if self.swap else self.cout, 8 * self.nt)

    @property
    def cols(self) -> int:
        return 9 * self.cin + 1

    @property
    def blocks(self) -> int:
        return _cdiv(self.cin + 1 if self.swap else self.cols, 32)

    @property
    def groups(self) -> int:
        return _cdiv(self.blocks, self.bpc)

    @property
    def warps(self) -> int:
        return self.bpc * self.kw

    @property
    def smem(self) -> int:
        br = 8 * self.nt
        ring = STAGES * KS * ((8 if br == 8 else br + 8) + 32 * self.bpc + 8)
        red = 32 * self.warps * br if self.kw > 1 else 0
        return 4 * max(ring, red)

    @property
    def workspace(self) -> int:
        """Floats of the chunks' partial tiles."""
        return self.chunks * self.cout * self.cols

    def ints(self) -> list[int]:
        return [self.batch, self.ih, self.iw, self.cin, self.oh, self.ow, self.cout,
                self.stride, self.pt, self.pl, self.nt, self.row_tiles, self.cols, self.blocks,
                self.bpc, self.groups, self.kw, self.chunks, self.chunk_px, int(self.vec_x),
                int(self.vec_g), self.smem, int(self.swap), *fast_div(self.ow),
                *fast_div(self.oh)]


def wgrad_plan(batch: int, H: int, W: int, cin: int, cout: int, stride: int, pads, sms: int,
               aligned_x: bool = True, aligned_g: bool = True) -> WgradPlan:
    """dW, db: N-side columns in tiles of up to 32, the M side in the
    fewest groups of at most eight blocks (a block alone takes four warps,
    two blocks two each, dealing each stage's steps), the pixels in chunks
    of whole stages, about WGRAD_WARPS_PER_SM warps per SM in all. `swap`
    where it gathers fewer bytes: stride 1, padding 1 (g's pixel at the
    centre tap is the input pixel, so the ones against it sum db), all
    9·cout taps of g in one tile, and cin ≥ 8."""
    pt, pb, pl, pr = pads
    OH, OW = out_size(H, stride, pt, pb), out_size(W, stride, pl, pr)
    swap = stride == 1 and tuple(pads) == (1, 1, 1, 1) and 9 * cout <= 32 and cin >= 8
    n_cols = 9 * cout if swap else cout
    nt = next(nt for nt in WGRAD_NTS if 8 * nt >= min(n_cols, 32))
    blocks = _cdiv((cin + 1) if swap else 9 * cin + 1, 32)
    bpc = _cdiv(blocks, _cdiv(blocks, WGRAD_MAX_WARPS))
    kw = {1: 4, 2: 2}.get(bpc, 1)
    P = batch * OH * OW
    per_chunk = _cdiv(blocks, bpc) * _cdiv(n_cols, 8 * nt) * bpc * kw
    chunks = max(1, min(_cdiv(sms * WGRAD_WARPS_PER_SM, per_chunk), _cdiv(P, KS)))
    chunk_px = _cdiv(_cdiv(P, chunks), KS) * KS
    return _with_ints(WgradPlan(batch, H, W, cin, OH, OW, cout, stride, pt, pl, nt, bpc, kw,
                                _cdiv(P, chunk_px), chunk_px, aligned_x and cin % 4 == 0,
                                aligned_g and cout % 4 == 0 and not swap, swap))


@functools.lru_cache(maxsize=None)
def _resident(index: int, kernel: int, nt: int, vec: bool, threads: int, smem: int) -> int:
    """CTAs of one kernel the card holds at once (the C query), once per
    device and shape of launch."""
    with torch.cuda.device(index):
        n = _build.load().gppvae_conv3x3_ctas(kernel, nt, int(vec), threads, smem)
    _build.check(-n if n < 0 else 0, "conv3x3 occupancy")
    return n


@functools.lru_cache(maxsize=None)
def _fprop_plan(index: int, *args) -> GemmPlan:
    plan = fprop_plan(*args)
    return plan.with_grid(_resident(index, 0, plan.nt, plan.vec, BM, plan.smem))


@functools.lru_cache(maxsize=None)
def _dgrad_plan(index: int, *args) -> GemmPlan:
    plan = dgrad_plan(*args)
    return plan.with_grid(_resident(index, 1, plan.nt, plan.vec, BM, plan.smem))


@functools.lru_cache(maxsize=None)
def _wgrad_plan(index: int, *args) -> WgradPlan:
    return wgrad_plan(*args[:7], _build.device_props(index)["sms"], *args[7:])


# ---- launches


def _check_cuda_f32(contiguous: bool = True, **ts: torch.Tensor) -> None:
    for name, t in ts.items():
        if not t.is_cuda:
            raise ValueError(f"conv3x3's kernels need CUDA tensors; {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"conv3x3's kernels take float32; {name} is {t.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"conv3x3's kernels take contiguous tensors; {name} is not "
                             f"(shape {tuple(t.shape)}, strides {t.stride()})")


def _check_shapes(x: torch.Tensor, weight: torch.Tensor, stride: int, pads) -> None:
    if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[2:]) != (3, 3) or \
            weight.shape[1] != x.shape[3]:
        raise ValueError(f"conv3x3 wants x NHWC (N, H, W, C) and weight (O, C, 3, 3); got "
                         f"{tuple(x.shape)}, {tuple(weight.shape)}")
    if stride not in (1, 2) or len(pads) != 4 or min(pads) < 0 or max(pads) > 2:
        raise ValueError(f"conv3x3 takes stride 1 or 2 and pads in 0..2; got {stride}, {pads}")
    if out_size(x.shape[1], stride, pads[0], pads[1]) < 1 or \
            out_size(x.shape[2], stride, pads[2], pads[3]) < 1:
        raise ValueError(f"conv3x3: input {tuple(x.shape[1:3])} too small for {pads}")
    if x.numel() >= 2**31 or x.shape[1] >= 2**15 or x.shape[2] >= 2**15:
        raise ValueError(f"conv3x3's kernels index in 32 bits; x {tuple(x.shape)} is too large")


# (device, stream) → scratch kept between calls and grown when a shape
# needs more (a layer's g, then the weight gradient's partial tiles): calls
# on one stream run in order, so each call's kernels are done with it before
# the next call's start.
_SCRATCH: dict = {}


def _workspace(dev, stream: int, floats: int) -> torch.Tensor:
    ws = _SCRATCH.get((dev, stream))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 0 if ws is None else ws.numel()), device=dev,
                         dtype=torch.float32)
        _SCRATCH[(dev, stream)] = ws
    return ws


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


@dataclass(frozen=True)
class _Layer:
    """One layer's launches on one device, planned once per shape: the
    output's shape and the three passes' plans (the data gradient's and the
    weight gradient's for a 16-byte aligned g, which `grads` makes)."""
    y_shape: tuple
    fprop: GemmPlan
    dgrad: GemmPlan
    wgrad: WgradPlan


@functools.lru_cache(maxsize=None)
def _layer(index: int, x_shape: tuple, w_shape: tuple, stride: int, pads: tuple, elu: bool,
           aligned: bool) -> _Layer:
    N, H, W, cin = x_shape
    cout = w_shape[0]
    _check_shapes(torch.empty(x_shape, device="meta"), torch.empty(w_shape, device="meta"),
                  stride, pads)
    fp = _fprop_plan(index, N, H, W, cin, cout, stride, pads, elu, aligned)
    return _Layer((N, fp.oh, fp.ow, cout), fp, _dgrad_plan(index, N, H, W, cin, cout, stride,
                                                           pads, True),
                  _wgrad_plan(index, N, H, W, cin, cout, stride, pads, aligned, True))


def fprop(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, stride: int,
          pads: tuple, elu: bool) -> tuple[torch.Tensor, _Layer]:
    """The forward pass, one ctypes call: (y = ELU(conv(x) + bias), or
    without ELU or bias, as a new NHWC tensor; the layer's plans, looked up
    once per call). Checks its inputs by name and counts
    `launch_conv3x3.fprop`."""
    if not (x.is_cuda and x.dtype == weight.dtype == torch.float32 and x.is_contiguous()
            and weight.is_contiguous() and (bias is None or bias.dtype == torch.float32)):
        _check_cuda_f32(x=x, weight=weight, **({} if bias is None else {"bias": bias}))
    dev = x.device
    with _on(dev):
        lay = _layer(dev.index, tuple(x.shape), tuple(weight.shape), stride, pads, elu,
                     x.data_ptr() % 16 == 0)
        y = torch.empty(lay.y_shape, device=dev, dtype=torch.float32)
        err = _build.load().gppvae_conv3x3_fprop(
            x.data_ptr(), weight.data_ptr(), _ptr(bias), y.data_ptr(), lay.fprop.c_ints,
            _stream(dev))
    _build.check(err, "conv3x3 fprop kernel")
    count(COUNTERS[0])
    return y, lay



def grads(lay: _Layer, dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
          y: torch.Tensor | None, want_x: bool = True, want_w: bool = True,
          has_bias: bool = True):
    """A layer's backward, one ctypes call: g = dy · ELU′ from the saved
    output y (1 where y > 0, else y + 1; g is dy where y is None), then dX
    (NHWC, where `want_x`) and dW (OIHW) and db (where `has_bias`) from g
    (where `want_w`). Returns (dx, dw, db), None for each not wanted; dW
    and db are two views of one allocation. Counts `launch_conv3x3.dgrad`
    and `.wgrad` for the passes it ran."""
    dy = dy.contiguous()
    if y is None and dy.data_ptr() % 16:
        dy = dy.clone()  # the plans read g in 16-byte copies
    dev = dy.device
    dx = dw = db = None
    with _on(dev):
        # g (where ELU′ applies) then the partial tiles in the scratch
        n = dy.numel() if y is not None else 0
        n16 = -(-n // 4) * 4
        scratch = _workspace(dev, _stream(dev), n16 + (lay.wgrad.workspace if want_w else 0))
        g = scratch[:n].view(dy.shape) if y is not None else None
        if want_x:
            dx = torch.empty(x.shape, device=dev, dtype=torch.float32)
        if want_w:
            nw, cout = weight.numel(), weight.shape[0]
            wb = torch.empty(nw + cout, device=dev, dtype=torch.float32)
            dw, db = wb[:nw].view(weight.shape), wb[nw:] if has_bias else None
        err = _build.load().gppvae_conv3x3_backward(
            dy.data_ptr(), _ptr(y), _ptr(g), x.data_ptr(), weight.data_ptr(), _ptr(dx),
            scratch[n16:].data_ptr(), _ptr(dw), _ptr(db), lay.dgrad.c_ints if want_x else None,
            lay.wgrad.c_ints if want_w else None, dy.numel(), _stream(dev))
    _build.check(err, "conv3x3 backward kernels")
    if want_x:
        count(COUNTERS[1])
    if want_w:
        count(COUNTERS[2])
    return dx, dw, db


class Conv3x3(torch.autograd.Function):
    """`fprop` forward and `grads` backward: the eager path (module
    docstring)."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, pads, elu):
        y, ctx.lay = fprop(x, weight, bias, stride, pads, elu)
        ctx.save_for_backward(x, weight, y if elu else None)
        ctx.has_bias = bias is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, y = ctx.saved_tensors
        dx, dw, db = grads(ctx.lay, dy, x, weight, y, ctx.needs_input_grad[0], True,
                           ctx.has_bias)
        return dx, dw, db, None, None, None


# The same two calls as custom operators, for graphs: torch.export and
# torch.compile trace `conv3x3` into gppvae::conv3x3 (and its backward into
# gppvae::conv3x3_backward), which an exported program runs on the card as
# the eager path does. Eager calls take the autograd.Function instead: the
# operator's dispatch (the dispatcher, then its own autograd wrapper) costs
# the host several times as much, and a training step makes forty calls.
@torch.library.custom_op("gppvae::conv3x3", mutates_args=(), device_types="cuda",
                         schema="(Tensor x, Tensor weight, Tensor? bias, int stride, "
                                "int[] pads, bool elu) -> Tensor")
def _conv3x3_op(x, weight, bias, stride, pads, elu):
    return fprop(x, weight, bias, stride, tuple(pads), elu)[0]


@_conv3x3_op.register_fake
def _(x, weight, bias, stride, pads, elu):
    # device and dtype only: a check of the batch size (contiguity, the
    # 32-bit index) would guard a symbolic batch; the kernels' call checks
    # the rest when the graph runs
    _check_cuda_f32(False, x=x, weight=weight, **({} if bias is None else {"bias": bias}))
    return x.new_empty((x.shape[0], out_size(x.shape[1], stride, pads[0], pads[1]),
                        out_size(x.shape[2], stride, pads[2], pads[3]), weight.shape[0]))


@torch.library.custom_op("gppvae::conv3x3_backward", mutates_args=(), device_types="cuda",
                         schema="(Tensor dy, Tensor x, Tensor weight, Tensor? y, int stride, "
                                "int[] pads, bool want_x, bool has_bias) -> "
                                "(Tensor, Tensor, Tensor)")
def _conv3x3_backward_op(dy, x, weight, y, stride, pads, want_x, has_bias):
    key = (x.device.index, tuple(x.shape), tuple(weight.shape), stride, tuple(pads),
           y is not None, x.data_ptr() % 16 == 0)
    with _on(x.device):
        lay = _layer(*key)
    dx, dw, db = grads(lay, dy, x, weight, y, want_x, True, has_bias)
    # an operator's outputs alias nothing: db out of dW's allocation, the
    # unwanted ones empty
    return (dx if want_x else dy.new_empty(0), dw,
            db.clone() if has_bias else dy.new_empty(0))


@_conv3x3_backward_op.register_fake
def _(dy, x, weight, y, stride, pads, want_x, has_bias):
    return (x.new_empty(x.shape if want_x else (0,)), weight.new_empty(weight.shape),
            weight.new_empty((weight.shape[0] if has_bias else 0,)))


def _op_setup(ctx, inputs, output):
    x, weight, bias, stride, pads, elu = inputs
    ctx.save_for_backward(x, weight, output if elu else None)
    ctx.args = stride, pads, bias is not None


def _op_backward(ctx, dy):
    x, weight, y = ctx.saved_tensors
    stride, pads, has_bias = ctx.args
    want_x = ctx.needs_input_grad[0]
    dx, dw, db = torch.ops.gppvae.conv3x3_backward(dy.contiguous(), x, weight, y, stride,
                                                   pads, want_x, has_bias)
    return dx if want_x else None, dw, db if has_bias else None, None, None, None


_conv3x3_op.register_autograd(_op_backward, setup_context=_op_setup)


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
            stride: int = 1, pads=(1, 1, 1, 1), elu: bool = False) -> torch.Tensor:
    """ELU(conv3x3(x) + bias) on the kernels (module docstring): float32
    CUDA tensors, else raises by name. Under torch.export or torch.compile
    the custom operator gppvae::conv3x3, else the autograd.Function."""
    if torch.compiler.is_compiling():
        return torch.ops.gppvae.conv3x3(x, weight, bias, stride, list(pads), elu)
    return Conv3x3.apply(x, weight, bias, stride, tuple(pads), elu)
