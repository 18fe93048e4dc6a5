"""c_graph_replays_per_step.train: the program's counter `C.graph_replay`
(one for each Phase C step that ran as a replay of its captured CUDA graph)
credited under `C.step`, per Phase C step of the traced run's card-only
slice (harness/spans.py): 1 where every step replays, 0 where every step
runs eager. None where the program never recorded the counter (a version
without graphs, or a run with no graph step)."""

from benchmark.harness import spans

COUNTER = "C.graph_replay"


def read(run):
    timers = spans.tracer()
    if timers is None or COUNTER not in timers.TRACER.counts:
        return None
    return spans.count_per_step(run, COUNTER)
