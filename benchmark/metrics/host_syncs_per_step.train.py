"""host_syncs_per_step.train: the program's counter `host_sync` (host reads
of a device value, each a wait for the card) credited under `C.step`, per
Phase C step of the traced run's card-only slice (harness/spans.py)."""

from benchmark.harness import spans


def read(run):
    return spans.count_per_step(run, "host_sync")
