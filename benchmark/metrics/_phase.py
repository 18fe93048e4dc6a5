"""The mean over the window's epochs of one of the trainer's phase spans
(its PhaseTimer: host clock around work that ends in a device sync)."""


def mean(run, phase: str, scale: float = 1.0):
    vals = [e[phase] for e in run.epochs if phase in e]
    return scale * sum(vals) / len(vals) if vals else None
