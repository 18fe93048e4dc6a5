"""The frozen FLOP, byte and peak arithmetic against values worked by hand."""

from __future__ import annotations

import types

import pytest
from conftest import ROOT  # noqa: F401  (puts the repository on the path)

from benchmark.harness import trace
from benchmark.harness.manifest import Manifest
from benchmark.yardstick import flops, kernel_cost, peaks


def test_peaks_are_the_published_h100_sxm_rates():
    assert (peaks.BF16_FLOPS, peaks.TF32_FLOPS, peaks.FP32_FLOPS) == (989e12, 495e12, 67e12)
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    # float32 on the tensor cores in split TF32: three TF32 products a float32 product
    assert peaks.SPLIT_TF32_FLOPS == 165e12
    assert peaks.STEP_PEAK == {"bfloat16": 989e12, "float32": 165e12}


@pytest.mark.parametrize("dtype, peak", [("float32", 165e12), ("bfloat16", 989e12)])
def test_the_step_readers_price_a_dtype_at_its_step_peak(dtype, peak):
    """train_mfu and vae_conv_roofline.train divide the same epoch FLOP by
    split TF32's peak for float32 and by bfloat16's for bfloat16."""
    enc, dec = 1_000_003, 2_000_029
    module = types.SimpleNamespace(vae_flops=lambda model, image_shape: (enc, dec))
    shapes = {"n_train": 4119, "n_heldout": 542, "zdim": 256, "rank": 576, "batch_size": 64,
              "image_shape": (128, 128, 3)}
    parts = flops.epoch_flops(enc, dec, **{k: v for k, v in shapes.items()
                                           if k != "image_shape"})
    # 4 epochs in 2 s; 3 epochs traced, 0.3 s of conv kernels among other work
    events = [{"cat": "kernel", "name": "conv3x3_fprop", "ts": 0.0, "dur": 1e5},
              {"cat": "kernel", "name": "conv3x3_wgrad", "ts": 2e5, "dur": 2e5},
              {"cat": "kernel", "name": "elementwise_kernel", "ts": 5e5, "dur": 3e5}]
    run = types.SimpleNamespace(
        epochs=[{}] * 4, window_s=2.0, shapes=shapes, slice=trace.Slice(events, 1.0, 3),
        cfg={"model": {"compute_dtype": dtype}, "reference_module": module})
    man = Manifest()
    assert man.reader("train_mfu")(run) == pytest.approx(100.0 * parts["total"] / 0.5 / peak)
    conv_work = parts["phase_a"] + parts["phase_c"] + parts["eval_oos"]
    assert man.reader("vae_conv_roofline.train")(run) == pytest.approx(
        100.0 * conv_work / 0.1 / peak)


def test_factor_prep_at_the_digits_shape():
    # G's symmetric half 5700·56·57, UᵀZ 2·5700·56·16; U, Z read, G, UᵀZ, ‖Z‖² written
    flop, nbytes = kernel_cost.factor_prep(5700, 56, 16)
    assert flop == 18_194_400 + 10_214_400
    assert nbytes == 4 * (5700 * 72 + 56 * 72 + 1) == 1_657_732
    assert peaks.least_seconds(flop, nbytes) == pytest.approx(1_657_732 / 3.35e12)


def test_nll_core_at_r56():
    # Cholesky and inverse 2·56³/3, W = X·UᵀZ 56²·16; G's half, UᵀZ, ‖Z‖², v_n in; NLL, X, W out
    flop, nbytes = kernel_cost.nll_core(56, 16)
    assert flop == pytest.approx(2 * 175_616 / 3 + 50_176)
    assert nbytes == 4 * (1596 + 896 + 3 + 3136 + 896) == 26_108


def test_encoder_forward_at_32x32():
    # convs 16²·1·32, 8²·32·64, 4²·64·128 (×9 taps ×2); dense 2048 → 128; heads 128 → 16 twice
    want = 2 * 9 * (256 * 32 + 64 * 32 * 64 + 16 * 64 * 128) + 2 * 2048 * 128 + 2 * 2 * 128 * 16
    assert flops.encoder_fwd_flops((32, 32, 1), (32, 64, 128), 16) == want == 5_398_528


def test_decoder_forms():
    # resize: dense 16 → 4·4·128, convs at 8², 16², 32² and the output conv
    resize = (2 * 16 * 2048 + 2 * 9 * (64 * 128 * 128 + 256 * 128 * 64 + 1024 * 64 * 32)
              + 2 * 9 * 1024 * 32)
    assert flops.decoder_fwd_flops((32, 32, 1), (128, 64, 32), 16) == resize
    # subpixel: a 2x2 conv over (h+1)(w+1) with 4f outputs at each stage
    sub = (2 * 16 * 2048 + 2 * (25 * 512 * 512 + 81 * 512 * 256 + 289 * 256 * 128)
           + 2 * 9 * 1024 * 32)
    assert flops.decoder_fwd_flops((32, 32, 1), (128, 64, 32), 16, "subpixel") == sub


def test_the_digits_epoch():
    e = flops.gppvae_epoch_flops(image_shape=(32, 32, 1), enc_features=(32, 64, 128),
                                 dec_features=(128, 64, 32), zdim=16, n_train=5700,
                                 n_heldout=400, batch_size=128, rank=56, upsample="subpixel")
    enc = 5_398_528
    dec = flops.decoder_fwd_flops((32, 32, 1), (128, 64, 32), 16, "subpixel")
    assert e["phase_a"] == 5700 * enc
    assert e["phase_b"] == 3 * (2 * 5700 * 56 * 72 + 2 * 5700 * 16 + 56**3)
    assert e["phase_c"] == 3 * 45 * 128 * (enc + dec)
    assert e["eval_oos"] == 400 * dec + 2 * 400 * 56 * 16
    assert e["total"] == sum(e[k] for k in ("phase_a", "phase_b", "phase_c", "eval_oos"))
    assert e["total"] == 1_077_788_601_728
