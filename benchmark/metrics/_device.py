"""The traced slice's device: the share of its wall time that no kernel,
copy or set covered, and its busy seconds per unit of work."""


def idle_percent(run):
    if run.slice is None or run.slice.wall_s <= 0:
        return None
    return 100.0 * (1.0 - run.slice.busy_s() / run.slice.wall_s)
