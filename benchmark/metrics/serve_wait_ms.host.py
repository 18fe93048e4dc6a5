"""serve_wait_ms.host: serve_wait_ms.serve's reading (milliseconds from the
end of one request's `serve.predict` span to the start of the next, mean over
the traced run's card-only slice) in a serving cell whose host sets the pace."""

from benchmark.harness import spans


def read(run):
    return spans.ms_between_requests(run)
