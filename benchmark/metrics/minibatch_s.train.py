"""minibatch_s.train: Phase C, the minibatch steps (_Loop.minibatch_epoch, train/optim.py),
seconds per epoch: the trainer's `sec_C_minibatch` span, averaged over
the unprofiled window's epochs."""

from benchmark.metrics._phase import mean


def read(run):
    return mean(run, "C_minibatch", 1.0)
