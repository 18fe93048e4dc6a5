"""c_forward_ms.train: the host's milliseconds per Phase C step in the
program's span `C.forward` (the batch's loss and metrics, enqueued: the
encoder, the decoder, the GP term), less its children, over the traced run's
card-only slice (harness/spans.py)."""

from benchmark.harness import spans


def read(run):
    return spans.ms_per_step(run, lambda name: name == "C.forward", own=True)
