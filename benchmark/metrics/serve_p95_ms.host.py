"""serve_p95_ms.host: the 95th percentile (nearest rank) of every window
request's latency, from when it was issued until its images were in host
memory, in milliseconds: the client's wait, on the host's clock, in a
serving cell whose host sets the pace."""

import math


def read(run):
    if not run.latencies:
        return None
    lat = sorted(run.latencies)
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
