"""serve_wait_ms.serve: milliseconds from the end of one request's
`serve.predict` span to the start of the next, mean over the traced run's
card-only slice (harness/spans.py): the client's wait for the card to finish
the request and copy its images to host memory, then the next request's
indices sent to the card."""

from benchmark.harness import spans


def read(run):
    return spans.ms_between_requests(run)
