"""serve_decode_ms.serve: the host's milliseconds per request in the
program's span `serve.decode` (eval/serving.py predict_images: the decoder's
forward, enqueued), over the traced run's card-only slice
(harness/spans.py)."""

from benchmark.harness import spans


def read(run):
    return spans.ms_per_request(run, "serve.decode")
