"""vae_conv_roofline.train: the VAE's share of an epoch's FLOP
(yardstick/flops.py epoch_flops, phases A, C and eval, of the per-image
encoder and decoder FLOP that the configuration's reference module gives)
over the traced slice's seconds per epoch in convolution kernels, against
the peak of the configuration's compute dtype (yardstick/peaks.py
STEP_PEAK), in percent: for float32 split TF32's 165 TFLOP/s, a third of
TF32's 495, since the program's float32 convolutions
(gppvae_tpu_torch/csrc/conv3x3.cu) take three TF32 products for each
float32 product; for bfloat16 989 TFLOP/s.

A kernel counts as a convolution's when its name holds one of PATTERNS, in
any case: cuDNN's implicit-GEMM and direct forward, data and weight
gradients (fprop, convolve, dgrad, wgrad, winograd), its FFT path (the FFTs
and their padding, the complex GEMMs between them, the region transforms),
the NHWC/NCHW layout transforms and the output scaling around its kernels.
On an H100 they caught 80.7 % of the traced slice's summed kernel time in
facevae128_train and 81.7 % in faces128_train; the rest is elementwise
work (ELU, adds, sums), resizes, the dense layers' GEMMs, the optimizer
and the GP. The FLOP are the direct form's: an
FFT or Winograd algorithm does fewer operations than that, so where cuDNN
picks one the share reads high. Eval's fresh encode of the training rows is
work that epoch_flops does not price (about 16 % of a FaceVAE epoch), and its
kernels are in the slice, so the share reads low by that much. The dense
layers and eval's GP product are under 0.1 % of the VAE's FLOP."""

from benchmark.yardstick import flops, peaks

PATTERNS = ("fprop", "convolve", "dgrad", "wgrad", "winograd", "fft", "cf32cf32",
            "region_transform", "nchwtonhwc", "nhwctonchw", "scalepackedtensor")


def is_conv(name: str) -> bool:
    name = name.lower()
    return any(p in name for p in PATTERNS)


def read(run):
    if run.slice is None or run.slice.units < 1:
        return None
    conv_s = sum(b - a for a, b, name in run.slice.device if is_conv(name)) / run.slice.units
    if conv_s <= 0:
        return None
    s, m = run.shapes, run.cfg["model"]
    enc, dec = run.cfg["reference_module"].vae_flops(m, s["image_shape"])
    parts = flops.epoch_flops(enc, dec, zdim=s["zdim"], n_train=s["n_train"],
                              n_heldout=s["n_heldout"], batch_size=s["batch_size"],
                              rank=s["rank"])
    work = parts["phase_a"] + parts["phase_c"] + parts["eval_oos"]
    return 100.0 * work / conv_s / peaks.STEP_PEAK[m["compute_dtype"]]
