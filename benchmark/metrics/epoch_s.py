"""epoch_s: the window's seconds over its whole epochs (host clock).

The window runs from its start to the end of its last epoch, so every
second of it, host work between the phases included, is in some epoch."""


def read(run):
    return run.window_s / len(run.epochs) if run.epochs else None
