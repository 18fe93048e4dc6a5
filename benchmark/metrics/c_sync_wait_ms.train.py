"""c_sync_wait_ms.train: the host's milliseconds per Phase C step in the
program's `sync.*` spans under `C.step` (each a host read of a device value,
the guard's `bool(isfinite(Σg²))`: the host waits there for the card to
finish what the step enqueued), over the traced run's card-only slice
(harness/spans.py)."""

from benchmark.harness import spans


def read(run):
    return spans.ms_per_step(run, lambda name: name.startswith("sync."))
