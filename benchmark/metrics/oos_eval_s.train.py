"""oos_eval_s.train: the held-out prediction (eval/oos.py predict_heldout), seconds per
epoch: the trainer's `sec_eval_oos` span, averaged over
the unprofiled window's epochs."""

from benchmark.metrics._phase import mean


def read(run):
    return mean(run, "eval_oos", 1.0)
