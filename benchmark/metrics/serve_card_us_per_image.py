"""serve_card_us_per_image: the card's busy time (the union of kernel, copy
and set intervals) per image asked, in microseconds, over a card-only slice
profiled after the window: whole blocks of the mix's sizes, so every seed
asks the same images (harness/cells.py serve). What each image handed back
costs the card: the GP prediction and the decode of eval/serving.py
predict_images, and the reply's copy to the host."""


def read(run):
    if run.slice is None or not run.slice_images:
        return None
    busy = run.slice.busy_s()
    return 1e6 * busy / run.slice_images if busy > 0 else None
