"""serve_gp_ms.serve: the host's milliseconds per request in the program's
span `serve.gp` (eval/serving.py predict_images: the asked rows' features
and the GP prediction from the folded core, enqueued), over the traced run's
card-only slice (harness/spans.py)."""

from benchmark.harness import spans


def read(run):
    return spans.ms_per_request(run, "serve.gp")
