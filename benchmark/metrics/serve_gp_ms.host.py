"""serve_gp_ms.host: serve_gp_ms.serve's reading (the host's milliseconds
per request in the program's span `serve.gp`, over the traced run's
card-only slice) in a serving cell whose host sets the pace."""

from benchmark.harness import spans


def read(run):
    return spans.ms_per_request(run, "serve.gp")
