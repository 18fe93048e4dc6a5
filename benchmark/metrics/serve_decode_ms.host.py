"""serve_decode_ms.host: serve_decode_ms.serve's reading (the host's milliseconds
per request in the program's span `serve.decode`, over the traced run's
card-only slice) in a serving cell whose host sets the pace."""

from benchmark.harness import spans


def read(run):
    return spans.ms_per_request(run, "serve.decode")
