"""vae_convs_per_step.train: the program's counter `vae.conv3x3` (each
forward of the VAE's encoder or decoder adds the convolutions it launched,
tallied where it launches them) credited under `C.step`, per Phase C step of the traced run's
card-only slice (harness/spans.py). None where the program never recorded
the counter (a version without it)."""

from benchmark.harness import spans

COUNTER = "vae.conv3x3"


def read(run):
    timers = spans.tracer()
    if timers is None or COUNTER not in timers.TRACER.counts:
        return None
    return spans.count_per_step(run, COUNTER)
