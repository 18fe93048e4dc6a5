"""Measure the streaming-conditioning (observe) fold rate of the PyTorch port.

The twin of tools/observe_throughput.py for gppvae_tpu_torch. For each
configuration it trains a model for 2 epochs, folds its training rows into
the serving core (`build_server_state`), then times chains of `chain` folds
of the same `bs` observed rows through eval/serving.py::observe, each fold
extending the core that the one before it left (row_mask all ones). The
folds of a chain are enqueued back to back with no host sync; each leaves
its checksum Σ core.M on the device, and the checksums are read back once,
at the end of the chain. One warm chain, then `reps` timed chains from the
same starting state; the best is kept.

    python tools/torch_observe_throughput.py [--device cuda|cpu] [--out FILE.json]

Prints one JSON line per configuration (digits 32² at 40 × 8, zdim 16;
faces 128² at 20 × 8, zdim 32, bfloat16 + subpixel; fold batch 200, chain
20) with the card's name and power limit. It runs on the card unless
`--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from types import SimpleNamespace

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CONFIGS = (
    ("digits32", dict(grid="rotated_digits", num_objects=40, num_views=8, image_size=32,
                      seed=0), dict(zdim=16)),
    ("faces128", dict(grid="faceplace", num_objects=20, num_views=8, image_size=128, seed=0),
     dict(zdim=32, obj_feature_dim=8, view_num_freqs=3, compute_dtype="bfloat16",
          dec_upsample="subpixel")),
)


def prepare(ds_kwargs: dict, model_kwargs: dict, *, bs: int = 200, device: str = "cuda"):
    """A model trained for 2 epochs at batch 64, its serving state, and the
    observation batch: `bs` training rows (tiled when there are fewer), all
    weighted 1."""
    import numpy as np
    import torch

    from bench_torch import build_dataset
    from gppvae_tpu_torch.eval.serving import build_server_state
    from gppvae_tpu_torch.train.train_gppvae import GPPVAETrainConfig, train_gppvae
    from gppvae_tpu_torch.utils import NullLogger

    ds = build_dataset(**ds_kwargs)
    cfg = GPPVAETrainConfig(epochs=2, batch_size=64, seed=0, **model_kwargs)
    res = train_gppvae(ds, cfg, device=device, log=NullLogger())
    d, extra = res.data, tuple(cfg.extra_effects)
    state = build_server_state(res.model, {"vae": res.model.state_dict(), "gp": res.gp_params},
                               res.fixed_W, d["images_tr"], d["d_tr"], d["q_tr"],
                               x_map=res.x_map, extra_effects=extra)
    rows = torch.as_tensor(np.resize(np.arange(len(ds.train_idx)), bs), device=d["d_tr"].device)
    return SimpleNamespace(model=res.model, state=state, x_map=res.x_map, extra=extra,
                           images=d["images_tr"][rows], d=d["d_tr"][rows], q=d["q_tr"][rows],
                           mask=torch.ones(bs, device=rows.device), bs=bs)


def fold_chain(p, state, chain: int):
    """`chain` folds of p's observation batch from `state`, back to back:
    (the state after the last, the (chain,) checksums Σ core.M on the device)."""
    import torch

    from gppvae_tpu_torch.eval.serving import observe

    sums = []
    for _ in range(chain):
        state = observe(p.model, state, p.images, p.d, p.q, x_map=p.x_map,
                        extra_effects=p.extra, encode_chunk=p.bs, row_mask=p.mask)
        sums.append(torch.sum(state.core.M))
    return state, torch.stack(sums)


def measure(name: str, ds_kwargs: dict, model_kwargs: dict, *, bs: int = 200, chain: int = 20,
            reps: int = 3, device: str = "cuda"):
    """(the JSON row, the state after the last timed chain)."""
    import torch

    p = prepare(ds_kwargs, model_kwargs, bs=bs, device=device)
    fold_chain(p, p.state, chain)[1].cpu()  # warm outside the timing
    times, final = [], None
    for _ in range(reps):
        if p.d.is_cuda:
            torch.cuda.synchronize(p.d.device)
        t0 = time.perf_counter()
        final, sums = fold_chain(p, p.state, chain)
        sums.cpu()
        times.append(time.perf_counter() - t0)
    best = min(times)
    return {
        "config": name,
        "fold_batch": bs,
        "chain": chain,
        "rank": int(p.state.core.G.shape[0]),
        "zdim": int(p.state.core.M.shape[1]),
        "best_s": round(best, 6),
        "folds_per_sec": round(chain / best, 1),
        "rows_per_sec": round(chain * bs / best),
    }, final


def main(argv=None):
    from bench_torch import device_info
    from gppvae_tpu_torch.train.device import resolve_device, set_float32_precision

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_float32_precision("float32")
    info = device_info(device)
    rows = []
    for name, ds_kwargs, model_kwargs in CONFIGS:
        row, _ = measure(name, ds_kwargs, model_kwargs, device=str(device))
        rows.append({**row, "device": info})
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"observe_throughput": rows}, f, indent=1)


if __name__ == "__main__":
    main()
