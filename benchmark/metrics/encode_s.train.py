"""encode_s.train: Phase A, the full encode (models/vae.py encode_all), seconds per
epoch: the trainer's `sec_A_encode` span, averaged over
the unprofiled window's epochs."""

from benchmark.metrics._phase import mean


def read(run):
    return mean(run, "A_encode", 1.0)
