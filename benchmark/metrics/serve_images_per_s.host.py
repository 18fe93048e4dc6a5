"""serve_images_per_s.host: serve_images_per_s's reading (images handed
back in the window over the window's seconds, host clock) in a serving cell
whose host sets the pace."""

from benchmark.metrics.serve_images_per_s import read  # noqa: F401
