"""train_mfu: the epoch's FLOP (yardstick/flops.py epoch_flops of the
per-image encoder and decoder FLOP that the configuration's reference module
gives, the decoder priced in its least-MAC form) over the unprofiled
window's seconds per epoch, against the peak of the configuration's compute
dtype (yardstick/peaks.py STEP_PEAK: split TF32's 165 TFLOP/s for float32,
989 TFLOP/s for bfloat16), in percent."""

from benchmark.yardstick import flops, peaks


def read(run):
    if not run.epochs:
        return None
    s, m = run.shapes, run.cfg["model"]
    enc, dec = run.cfg["reference_module"].vae_flops(m, s["image_shape"])
    work = flops.epoch_flops(enc, dec, zdim=s["zdim"], n_train=s["n_train"],
                             n_heldout=s["n_heldout"], batch_size=s["batch_size"],
                             rank=s["rank"])["total"]
    epoch_s = run.window_s / len(run.epochs)
    return 100.0 * work / epoch_s / peaks.STEP_PEAK[m["compute_dtype"]]
