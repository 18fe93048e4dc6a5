"""serve_images_per_s: images handed back in the window over the window's
seconds (host clock)."""


def read(run):
    return run.images / run.window_s if run.latencies else None
