"""serve_device_ms.serve: the card's busy time (the union of kernel, copy
and set intervals) per request in the traced slice, in milliseconds: the GP
prediction and the decode of eval/serving.py predict_images, and the
reply's copy to the host."""


def read(run):
    if run.slice is None or not run.slice.units:
        return None
    return 1e3 * run.slice.busy_s() / run.slice.units
