"""c_optim_ms.train: the host's milliseconds per Phase C step in the
program's span `C.optim` (both guarded Adams: Σg², the clip, the update),
less its children, the waits at the guard's reads (`sync.guard`), over the
traced run's card-only slice (harness/spans.py)."""

from benchmark.harness import spans


def read(run):
    return spans.ms_per_step(run, lambda name: name == "C.optim", own=True)
