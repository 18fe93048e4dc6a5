"""conv3x3's launch plans, and the kernels' split-TF32 arithmetic, on the CPU.

`fprop_plan`, `dgrad_plan` and `wgrad_plan` (gppvae_tpu_torch/ops/conv3x3.py)
are plain functions of the shape; the kernels (csrc/conv3x3.cu) check the
plans' integers, and these tests check that the plans cover what the
kernels assume: every shape of the four cells (at batch 64), the digits
widths, a tensor-parallel block of 16 output channels and odd sizes fit an
H100 block's shared memory, and the classes' taps, run as the kernels index
them (`gather_gemm`), give the convolution and its data gradient.

`emulate_stage_sums` runs the kernels' arithmetic in numpy: every operand
split as x = hi + lo in TF32 (`tf32`, the rounding of hopper.cuh's
split_rn), lo·hi + hi·lo + hi·hi of each 8-deep step summed into a fresh
float32 accumulator per stage of 32, rounded toward zero as the tensor cores
round (`toward_zero`), each stage added to the running sum rounded to
nearest, in the kernels' fixed order. Held to float64, it keeps the forward
pass, the data gradient and the weight gradient (K = pixels, per chunk, the
chunks summed in order) within the float32 plain version's distance, where
one TF32 pass does not.
"""

import importlib
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from _one_thread import one_thread  # noqa: F401
from test_torch_factor_prep_plan import toward_zero
from test_torch_nll_core_plan import tf32

from gppvae_tpu_torch import ops
from gppvae_tpu_torch.models import VAE

cv = importlib.import_module("gppvae_tpu_torch.ops.conv3x3")  # ops.conv3x3: the function

F32, F64 = np.float32, np.float64
SMEM_OPTIN = 232448  # an H100 block's shared memory (bytes)
SMS = 132
SAME = (0, 1, 0, 1)  # flax 'SAME' at stride 2 on an even axis
PAD1 = (1, 1, 1, 1)
# (batch, H, W, cin, cout, stride, pads): the cells' convolutions at batch 64
# (FaceVAE's two a stage, the port's faces layout's one, both decoders' last),
# the digits widths, a tensor-parallel block, odd sizes
SHAPES = [
    (64, 128, 128, 3, 32, 1, PAD1), (64, 128, 128, 32, 32, 2, PAD1),
    (64, 64, 64, 32, 32, 1, PAD1), (64, 64, 64, 32, 32, 2, PAD1),
    (64, 8, 8, 32, 32, 1, PAD1), (64, 4, 4, 32, 32, 1, PAD1), (64, 8, 8, 32, 32, 2, PAD1),
    (64, 128, 128, 32, 3, 1, PAD1), (64, 128, 128, 3, 3, 1, PAD1),
    (64, 128, 128, 3, 32, 2, SAME), (64, 64, 64, 32, 32, 2, SAME), (64, 4, 4, 32, 32, 2, SAME),
    (64, 128, 128, 32, 32, 1, PAD1), (64, 128, 128, 32, 3, 1, PAD1),
    (128, 32, 32, 1, 32, 2, SAME), (128, 16, 16, 32, 64, 2, SAME), (128, 8, 8, 64, 128, 2, SAME),
    (128, 8, 8, 128, 64, 1, PAD1), (128, 16, 16, 64, 32, 1, PAD1), (128, 32, 32, 32, 1, 1, PAD1),
    (64, 64, 64, 32, 16, 1, PAD1), (64, 64, 64, 16, 32, 1, PAD1),
    (5, 7, 9, 5, 7, 2, PAD1), (3, 9, 7, 6, 13, 1, PAD1), (2, 5, 6, 12, 20, 2, SAME),
    (1, 1, 1, 4, 4, 1, PAD1), (2, 3, 3, 2, 1, 2, (0, 0, 0, 0)), (1, 2, 2, 3, 5, 2, (1, 0, 0, 1)),
]


def _cdiv(a, b):
    return -(-a // b)


def _shape_id(s):
    return "x".join(map(str, s[:6])) + "p" + "".join(map(str, s[6]))


# ---- the plans cover the shapes


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_plans_fit_and_cover_every_shape(shape):
    """Shared memory within an H100 block's; the tiles cover each class's
    pixels; dgrad's classes cover every input pixel once and every tap of
    each axis once; the weight gradient's chunks cover every output pixel
    and its columns every (tap, channel) and db."""
    N, H, W, cin, cout, stride, pads = shape
    fp = cv.fprop_plan(N, H, W, cin, cout, stride, pads, True)
    dg = cv.dgrad_plan(N, H, W, cin, cout, stride, pads)
    wg = cv.wgrad_plan(N, H, W, cin, cout, stride, pads, SMS)
    OH, OW = cv.out_size(H, stride, pads[0], pads[1]), cv.out_size(W, stride, pads[2], pads[3])
    for plan in (fp, dg):
        assert plan.smem <= SMEM_OPTIN - 4096
        assert len(plan.ints()) == 18 + 31 * cv.MAX_CLASSES
        assert plan.grid_n * 8 * plan.nt >= plan.cn
        for c in plan.classes:
            assert c.tiles(N) * cv.BM >= N * c.gh * c.gw
    assert (fp.oh, fp.ow, fp.cn, fp.cg) == (OH, OW, cout, cin)
    assert (dg.ih, dg.iw, dg.oh, dg.ow, dg.cn, dg.cg) == (OH, OW, H, W, cin, cout)
    covered = np.zeros((H, W), int)
    for c in dg.classes:
        covered[c.oy0::c.ostep, c.ox0::c.ostep] += 1
        assert covered[c.oy0::c.ostep, c.ox0::c.ostep].shape == (c.gh, c.gw)
    assert (covered == 1).all()
    rows = sorted(r for c in dg.classes if c.ox0 == 0 for r, _ in c.rows)
    assert rows == [0, 1, 2]
    assert wg.smem <= SMEM_OPTIN - 4096 and len(wg.ints()) == 29
    assert wg.chunks * wg.chunk_px >= N * OH * OW > (wg.chunks - 1) * wg.chunk_px
    assert wg.chunk_px % cv.KS == 0 and wg.cols == 9 * cin + 1
    assert wg.swap == (stride == 1 and pads == PAD1 and 9 * cout <= 32 and cin >= 8)
    assert wg.groups * wg.bpc * 32 >= (cin + 1 if wg.swap else wg.cols)
    assert wg.row_tiles * 8 * wg.nt >= (9 * cout if wg.swap else cout)
    assert wg.warps <= cv.WGRAD_MAX_WARPS
    assert wg.vec_x == (cin % 4 == 0) and wg.vec_g == (cout % 4 == 0 and not wg.swap)


def test_unaligned_pointers_take_the_4_byte_copies():
    assert cv.fprop_plan(2, 8, 8, 32, 32, 1, PAD1, True).vec
    assert not cv.fprop_plan(2, 8, 8, 32, 32, 1, PAD1, True, aligned=False).vec
    assert not cv.fprop_plan(2, 8, 8, 3, 32, 1, PAD1, True).vec
    assert not cv.dgrad_plan(2, 8, 8, 32, 3, 1, PAD1).vec
    w = cv.wgrad_plan(2, 8, 8, 32, 32, 1, PAD1, SMS, aligned_x=False)
    assert not w.vec_x and w.vec_g


def test_with_grid_caps_the_persistent_ctas():
    plan = cv.fprop_plan(64, 64, 64, 32, 32, 1, PAD1, True)
    assert plan.with_grid(264).grid_m == 264 < plan.tiles
    assert plan.with_grid(10**6).grid_m == plan.tiles
    assert plan.with_grid(264).c_ints[14] == 264  # the C struct's grid_m


def test_wide_sources_shrink_the_channel_tile():
    """The weights stay resident: a wide K takes fewer output channels a
    tile, and K past the shared memory is refused by name."""
    assert cv.fprop_plan(2, 8, 8, 32, 64, 1, PAD1, True).nt == 8
    assert cv.fprop_plan(2, 8, 8, 128, 128, 1, PAD1, True).nt == 4
    assert cv.fprop_plan(2, 8, 8, 512, 128, 1, PAD1, True).nt == 1
    with pytest.raises(ValueError, match="source channels"):
        cv.fprop_plan(2, 8, 8, 1024, 8, 1, PAD1, True)


def test_fast_division_matches_python():
    rng = np.random.default_rng(0)
    for d in [*range(1, 200), 4096, 16384, 65536, 1 << 20, 1_000_003]:
        _, mul, shr = cv.fast_div(d)
        m = mul & 0xFFFFFFFF
        for n in [0, 1, d - 1, d, d + 1, 2**31 - 1, *rng.integers(0, 2**31, 50).tolist()]:
            assert ((((n * m) >> 32) + n) & 0xFFFFFFFF) >> shr == n // d, (d, n)


# ---- the kernels' indexing, run in numpy


def gather_gemm(plan, src, w):
    """The output of one fprop or dgrad plan as the kernel indexes it:
    per class and output pixel, the source at o·istep + off per tap (zero
    outside), against w[n·sn + c·sc + 3r + s]; float64."""
    N = src.shape[0]
    out = np.zeros((N, plan.oh, plan.ow, plan.cn))
    wf = np.asarray(w, F64).reshape(-1)
    for c in plan.classes:
        taps = [(r, ro, s, so) for r, ro in c.rows for s, so in c.cols]
        oy, ox = np.meshgrid(np.arange(c.gh), np.arange(c.gw), indexing="ij")
        for r, ro, s, so in taps:
            iy, ix = oy * c.istep + ro, ox * c.istep + so
            ok = (iy >= 0) & (iy < plan.ih) & (ix >= 0) & (ix < plan.iw)
            a = np.where(ok[None, :, :, None], src[:, iy.clip(0, plan.ih - 1),
                                                   ix.clip(0, plan.iw - 1)], 0.0)
            idx = (np.arange(plan.cn)[None, :] * plan.sn + np.arange(plan.cg)[:, None] * plan.sc
                   + 3 * r + s)
            out[:, c.oy0::c.ostep, c.ox0::c.ostep] += a @ wf[idx]
    return out


def _problem(shape, seed=0):
    N, H, W, cin, cout, stride, pads = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H, W, cin))
    w = rng.standard_normal((cout, cin, 3, 3)) / math.sqrt(9 * cin)
    OH, OW = cv.out_size(H, stride, pads[0], pads[1]), cv.out_size(W, stride, pads[2], pads[3])
    dy = rng.standard_normal((N, OH, OW, cout))
    return x, w, dy


def _torch_passes(shape, x, w, dy):
    """y, dX, dW in float64 by F.conv2d and autograd (NHWC)."""
    _, _, _, _, _, stride, (pt, pb, pl, pr) = shape
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    y = F.conv2d(F.pad(xt.permute(0, 3, 1, 2), (pl, pr, pt, pb)), wt, None, stride)
    y = y.permute(0, 2, 3, 1)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.tensor(dy))
    return y.detach().numpy(), dx.numpy(), dw.numpy()


SMALL = [(2, 7, 9, 5, 7, 2, PAD1), (2, 6, 6, 4, 8, 2, SAME), (1, 5, 4, 3, 2, 1, PAD1),
         (2, 8, 8, 8, 3, 2, PAD1), (1, 3, 3, 2, 1, 2, (0, 0, 0, 0)), (1, 4, 5, 3, 5, 2, (1, 0, 0, 1))]


@pytest.mark.parametrize("shape", SMALL, ids=_shape_id)
def test_plans_index_the_convolution_and_its_data_gradient(shape):
    N, H, W, cin, cout, stride, pads = shape
    x, w, dy = _problem(shape)
    y, dx, dw = _torch_passes(shape, x, w, dy)
    fp = cv.fprop_plan(N, H, W, cin, cout, stride, pads, False)
    np.testing.assert_allclose(gather_gemm(fp, x, w), y, atol=1e-12)
    dg = cv.dgrad_plan(N, H, W, cin, cout, stride, pads)
    np.testing.assert_allclose(gather_gemm(dg, dy, w), dx, atol=1e-12)
    # the weight gradient's columns: J = tap·cin + ci reads x at o·stride − pad + tap
    OH, OW = dy.shape[1:3]
    xp = np.pad(x, ((0, 0), (pads[0], 2), (pads[2], 2), (0, 0)))
    cols = np.stack([xp[:, r:r + stride * OH:stride, s:s + stride * OW:stride]
                     for r in range(3) for s in range(3)], 3).reshape(N * OH * OW, 9 * cin)
    got = dy.reshape(-1, cout).T @ cols
    np.testing.assert_allclose(got.reshape(cout, 3, 3, cin).transpose(0, 3, 1, 2), dw,
                               atol=1e-12)


@pytest.mark.parametrize("shape", [(2, 6, 5, 8, 3, 1, PAD1), (1, 4, 4, 12, 2, 1, PAD1)],
                         ids=_shape_id)
def test_swapped_weight_gradient_indexes_dw_and_db(shape):
    """The swapped weight gradient as the kernel indexes it: K over the
    input pixels q, the M side [x[q] | 1], the N side g at q + 1 − (r, s)
    per column tap·cout + co (zero outside), its tile written to dW's
    column tap·cin + ci and, from the ones against the centre tap, db."""
    N, H, W, cin, cout, stride, pads = shape
    assert cv.wgrad_plan(N, H, W, cin, cout, stride, pads, SMS).swap
    x, w, dy = _problem(shape)
    _, _, dw = _torch_passes(shape, x, w, dy)
    m_side = np.concatenate([x.reshape(-1, cin), np.ones((N * H * W, 1))], 1)
    gp = np.pad(dy, ((0, 0), (2, 2), (2, 2), (0, 0)))
    n_side = np.stack([gp[:, 1 + 2 - r:1 + 2 - r + H, 1 + 2 - s:1 + 2 - s + W]
                       for r in range(3) for s in range(3)], 3).reshape(N * H * W, 9 * cout)
    tile = m_side.T @ n_side  # (cin + 1, tap·cout + co)
    got = tile[:cin].reshape(cin, 3, 3, cout).transpose(3, 0, 1, 2)
    np.testing.assert_allclose(got, dw, atol=1e-12)
    np.testing.assert_allclose(tile[cin].reshape(9, cout)[4], dy.sum((0, 1, 2)), atol=1e-12)


# ---- the arithmetic


def emulate_stage_sums(A, B, passes: int = 3, chunks: int = 1):
    """A (m, K) · B (K, n) as the kernels sum it: K in chunks (the weight
    gradient's pixel chunks; the partial products added in chunk order),
    each in stages of 32 (zero-padded), each stage's 8-deep steps of
    lo·hi + hi·lo + hi·hi (passes 3) or hi·hi (passes 1) into a fresh
    accumulator rounded toward zero, added to the running sum."""
    K = A.shape[1]
    per = _cdiv(_cdiv(K, chunks), 32) * 32
    A = np.pad(np.asarray(A, F32), ((0, 0), (0, per * chunks - K)))
    B = np.pad(np.asarray(B, F32), ((0, per * chunks - K), (0, 0)))
    ah, bh = tf32(A).reshape(A.shape), tf32(B).reshape(B.shape)
    al, bl = tf32(A - ah).reshape(A.shape), tf32(B - bh).reshape(B.shape)
    pairs = [(al, bh), (ah, bl), (ah, bh)] if passes == 3 else [(ah, bh)]
    total = np.zeros((A.shape[0], B.shape[1]), F32)
    for c in range(chunks):
        acc = np.zeros_like(total)
        for k0 in range(c * per, (c + 1) * per, 32):
            step = np.zeros_like(total)
            for k8 in range(k0, k0 + 32, 8):
                for a, b in pairs:
                    step = toward_zero(step + a[:, k8:k8 + 8].astype(F64) @ b[k8:k8 + 8].astype(F64))
            acc = (acc + step).astype(F32)
        total = (total + acc).astype(F32)
    return total


def _im2col(x, stride, pads, OH, OW):
    """(N·OH·OW, 9·cin) with column tap·cin + ci, the kernels' K order."""
    N, H, W, cin = x.shape
    xp = np.pad(x, ((0, 0), (pads[0], 2), (pads[2], 2), (0, 0)))
    return np.stack([xp[:, r:r + stride * OH:stride, s:s + stride * OW:stride]
                     for r in range(3) for s in range(3)], 3).reshape(N * OH * OW, 9 * cin)


def distances(shape, passes: int = 3, seed: int = 0) -> dict:
    """Each pass's max abs error from float64 over max |float64|: the
    emulated kernel arithmetic and the float32 plain version."""
    N, H, W, cin, cout, stride, pads = shape
    x, w, dy = _problem(shape, seed)
    x32, w32, dy32 = x.astype(F32), w.astype(F32), dy.astype(F32)
    y, dx, dw = _torch_passes(shape, x32.astype(F64), w32.astype(F64), dy32.astype(F64))
    OH, OW = dy.shape[1:3]
    Wm = w32.transpose(2, 3, 1, 0).reshape(9 * cin, cout)  # (tap·cin + ci, co)
    emu_y = emulate_stage_sums(_im2col(x32, stride, pads, OH, OW), Wm, passes)
    wg = cv.wgrad_plan(N, H, W, cin, cout, stride, pads, SMS)
    cols = _im2col(x32, stride, pads, OH, OW)
    emu_dw = emulate_stage_sums(cols.T, dy32.reshape(-1, cout), passes, wg.chunks)
    emu_dw = emu_dw.reshape(3, 3, cin, cout).transpose(3, 2, 0, 1)
    # stride 1: dX is the conv of dY with the kernel turned and transposed
    Wd = w32[:, :, ::-1, ::-1].transpose(2, 3, 0, 1).reshape(9 * cout, cin)
    emu_dx = (emulate_stage_sums(_im2col(dy32, 1, pads, H, W), Wd, passes)
              if stride == 1 else None)
    xt, wt = torch.tensor(x32, requires_grad=True), torch.tensor(w32, requires_grad=True)
    pt, pb, pl, pr = pads
    yt = F.conv2d(F.pad(xt.permute(0, 3, 1, 2), (pl, pr, pt, pb)), wt, None, stride)
    yt = yt.permute(0, 2, 3, 1)
    pdx, pdw = torch.autograd.grad(yt, (xt, wt), torch.tensor(dy32))

    def rel(got, want):
        return float(np.max(np.abs(np.asarray(got, F64) - want)) / np.max(np.abs(want)))

    out = {"shape": list(shape[:6]), "passes": passes,
           "emulated": {"y": rel(emu_y.reshape(y.shape), y), "dw": rel(emu_dw, dw)},
           "plain_f32": {"y": rel(yt.detach().numpy(), y), "dw": rel(pdw.numpy(), dw),
                         "dx": rel(pdx.numpy(), dx)}}
    if emu_dx is not None:
        out["emulated"]["dx"] = rel(emu_dx.reshape(dx.shape), dx)
    return out


ARITH = [(2, 16, 16, 32, 32, 1, PAD1), (4, 32, 32, 3, 32, 1, PAD1), (2, 16, 16, 32, 3, 2, PAD1)]


@pytest.mark.parametrize("shape", ARITH, ids=_shape_id)
def test_split_tf32_arithmetic_keeps_float32s_distance(shape):
    """Each pass within 1e-6 of float64 and within 5× the float32 plain
    version's own distance (the plain version sums in another order, and
    its distance ranges over 1.2e-7 – 9e-7 at these shapes)."""
    d = distances(shape)
    for k, e in d["emulated"].items():
        assert e <= 1e-6 and e <= 5 * d["plain_f32"][k], d


@pytest.mark.parametrize("shape", ARITH[:2], ids=_shape_id)
def test_one_plain_tf32_pass_would_not(shape):
    """hi·hi alone (one TF32 pass, ~3 decimal digits) is past 1e-5 of
    float64 in every pass, over 100× the float32 plain version's distance."""
    d = distances(shape, passes=1)
    for k, e in d["emulated"].items():
        assert e > 1e-5 and e > 100 * d["plain_f32"][k], d


# ---- the VAE on the CPU


@pytest.mark.parametrize("layout", ["port", "facevae"])
def test_cpu_vae_launches_nothing_and_runs_the_plain_version(layout):
    feats = (8, 16)
    model = VAE(6, (16, 16, 3), feats, feats[::-1], key=1, vae_layout=layout)
    y = torch.rand(3, 16, 16, 3)
    ops.reset_launch_counts()
    before = ops.plain_calls()["conv3x3"]
    mu, logvar = model.encode(y)
    logits = model.decode(mu)
    (logits.sum() + logvar.sum()).backward()
    convs = len(model.encoder.convs) + len(model.decoder.convs) + (layout == "port")
    assert ops.plain_calls()["conv3x3"] - before == convs
    assert set(ops.launch_counts().values()) == {0}
    assert logits.shape == (3, 16, 16, 3) and logits.is_contiguous()


def test_plain_version_is_the_aten_layer():
    """conv3x3_torch is F.conv2d on the NCHW view (F.pad where the sides
    differ) and F.elu, NHWC out, bit for bit."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((2, 9, 8, 4)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((5, 4, 3, 3)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal(5), dtype=torch.float32)
    h = x.permute(0, 3, 1, 2)
    got = ops.conv3x3_torch(x, w, b, 2, SAME, True)
    want = F.elu(F.conv2d(F.pad(h, (0, 1, 0, 1)), w, b, 2)).permute(0, 2, 3, 1)
    assert torch.equal(got, want)
    got = ops.conv3x3_torch(x, w, None, 1, PAD1, False)
    assert torch.equal(got, F.conv2d(h, w, None, 1, 1).permute(0, 2, 3, 1))


def test_other_devices_raise():
    """ops.conv3x3 is the kernels alone: a tensor off the card is refused
    by name, the CPU's too (the VAE calls the plain version there)."""
    for device in ("meta", "cpu"):
        x = torch.empty((1, 4, 4, 2), device=device)
        w = torch.empty((3, 2, 3, 3), device=device)
        with pytest.raises(ValueError, match=f"need CUDA tensors; x is on {device}"):
            ops.conv3x3(x, w)


# ---- graphs: torch.export keeps the kernels (fake CUDA tensors, no card)


def _fake_cuda_params(model):
    for mod in model.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            setattr(mod, name, torch.nn.Parameter(
                torch.empty(p.shape, dtype=p.dtype, device="cuda"), requires_grad=False))


@pytest.mark.parametrize("layout,dtype,convs", [
    ("port", torch.float32, 2), ("facevae", torch.float32, 4), ("port", torch.bfloat16, 0),
    ("facevae", torch.bfloat16, 0)])
def test_exported_encoder_holds_the_conv3x3_operator(layout, dtype, convs):
    """torch.export of the encoder on (fake) CUDA tensors, as `serve
    --export_exe` runs it (any batch size): in float32 every convolution is the custom
    operator gppvae::conv3x3, which runs the kernels, and no aten
    convolution is left; in bfloat16 the aten ops, as in eager."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    model = VAE(6, (16, 16, 3), (8, 16), (16, 8), key=1, vae_layout=layout, dtype=dtype)
    with FakeTensorMode(allow_non_fake_inputs=True):
        _fake_cuda_params(model)
        y = torch.empty(3, 16, 16, 3, device="cuda")
        with torch.no_grad():  # the batch symbolic from 1 up, as serving's entries have it
            program = torch.export.export(model.encoder, (y,), strict=False,
                                          dynamic_shapes=({0: torch.export.Dim("b", min=1)},))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("gppvae.conv3x3.default") == convs
    aten = [t for t in targets if t.startswith("aten.conv")]
    assert len(aten) == (0 if convs else len(model.encoder.convs))


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[0] <= 64][:6], ids=_shape_id)
def test_operators_fake_shapes(shape):
    """gppvae::conv3x3's and gppvae::conv3x3_backward's shapes under
    tracing (their fake kernels) are those the plans give; the unwanted
    gradients come back empty."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    n, h, w, cin, cout, stride, pads = shape
    plan = cv.fprop_plan(n, h, w, cin, cout, stride, pads, True)
    with FakeTensorMode():
        x = torch.empty(n, h, w, cin, device="cuda")
        wt = torch.empty(cout, cin, 3, 3, device="cuda")
        y = torch.ops.gppvae.conv3x3(x, wt, torch.empty(cout, device="cuda"), stride,
                                     list(pads), True)
        assert tuple(y.shape) == (n, plan.oh, plan.ow, cout) and y.is_cuda
        dx, dw, db = torch.ops.gppvae.conv3x3_backward(y, x, wt, y, stride, list(pads), True,
                                                       True)
        assert (dx.shape, dw.shape, db.shape) == (x.shape, wt.shape, (cout,))
        dx, _, db = torch.ops.gppvae.conv3x3_backward(y, x, wt, None, stride, list(pads),
                                                      False, False)
        assert dx.numel() == db.numel() == 0


def test_operator_refuses_float64_under_tracing():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(), pytest.raises(TypeError, match="float32; x is torch.float64"):
        torch.ops.gppvae.conv3x3(torch.empty(2, 8, 8, 4, device="cuda", dtype=torch.float64),
                                 torch.empty(5, 4, 3, 3, device="cuda"), None, 1, list(PAD1),
                                 False)


if __name__ == "__main__":
    for shape in ARITH:
        for passes in (3, 1):
            print(distances(shape, passes))
