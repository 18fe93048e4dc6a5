"""train_mfu: the epoch's FLOP (yardstick/flops.py, the decoder priced in
its least-MAC form) over the unprofiled window's seconds per epoch, against
the published peak of the configuration's compute dtype
(yardstick/peaks.py STEP_PEAK), in percent."""

from benchmark.yardstick import flops, peaks


def read(run):
    if not run.epochs:
        return None
    s, m = run.shapes, run.cfg["model"]
    work = flops.gppvae_epoch_flops(
        image_shape=s["image_shape"], enc_features=m["enc_features"],
        dec_features=m["dec_features"], zdim=s["zdim"], n_train=s["n_train"],
        n_heldout=s["n_heldout"], batch_size=s["batch_size"], rank=s["rank"],
        upsample=m["dec_upsample"])["total"]
    epoch_s = run.window_s / len(run.epochs)
    return 100.0 * work / epoch_s / peaks.STEP_PEAK[m["compute_dtype"]]
