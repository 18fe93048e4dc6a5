"""The two lowerings of the subpixel decoder timed against each other, on the GPU.

    python3 tools/torch_subpixel_lowering.py [--rounds 1]

models/vae.py runs `upsample='subpixel'` as the JAX package's tap-merged
lowering (`_upconv`: one stride-2 transposed conv with the merged 4×4
kernel) in bfloat16 and as the resize forward (nearest ×2, then the 3×3
conv: the same function in float32, another in bfloat16) in float32. The
third lowering of the same stage is the merged kernel as a conv over the
input dilated by 2 (`dilated`, the merged one's function). This times them
against each other, so that the choice per dtype rests on the card's
numbers. Prints JSON lines:

  1. `decoder`: the decoder alone at the published widths (128, 64, 32) for
     digits 32²×1 (zdim 16, the training batch 128) and faces 128²×3 (zdim
     32, batch 64), in float32 and bfloat16, each lowering: one training
     step's forward and backward (the gradients of sum(logits · C)), and a
     200-image decode without gradients; ms per call, CUDA events over 20
     calls, the median of 5;
  2. `epoch`: GPPVAE-joint training, float32 with the subpixel decoder,
     one run per lowering in turns resize / merged / merged / resize (×
     --rounds): bench_torch.py's gppvae_joint_f32 grid (digits, 12 epochs,
     the first 4 left out) and face_view_128's (faces 128², 6 epochs, the
     first 3 left out); the median, min and spread of sec/epoch, unrounded.

The resize and merged lowerings run through models/vae.py's own `_conv` /
`_upconv`; `module_runs` names those that equal the module's own forward
bit for bit (cuDNN may pick another algorithm from one call to the next,
so it can name none). Needs CUDA; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gppvae_tpu_torch.models import ConvDecoder  # noqa: E402
from gppvae_tpu_torch.models import vae  # noqa: E402
from gppvae_tpu_torch.train.device import set_float32_precision  # noqa: E402

SHAPES = {"digits": ((32, 32, 1), 16, 128), "faces_128": ((128, 128, 3), 32, 64)}
FEATURES = (128, 64, 32)
SERVE_BATCH = 200
# bench_torch.py's gppvae_joint_f32 and face_view_128, depth cut, subpixel
EPOCH_RUNS = {
    "digits": (dict(source="synthetic", num_objects=400, num_views=16, seed=0, image_size=32),
               dict(mode="joint", zdim=16, epochs=12, batch_size=128, obj_feature_dim=8,
                    view_num_freqs=3, seed=0, dec_upsample="subpixel"), 4),
    "faces_128": (dict(source="faces", num_objects=50, num_views=8, seed=0, image_size=128),
                  dict(mode="joint", zdim=32, epochs=6, batch_size=64, obj_feature_dim=8,
                       view_num_freqs=3, seed=0, dec_upsample="subpixel"), 3),
}


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _dilated(conv, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The merged 4×4 kernel over x dilated by 2 (zeros between the
    pixels), padding 2: `_upconv`'s function as a plain conv."""
    n, c, h, w = x.shape
    u = x.new_zeros((n, c, 2 * h - 1, 2 * w - 1), dtype=dt)
    u[:, :, ::2, ::2] = x
    return (F.conv2d(u, vae._merge_taps(conv.weight.to(dt)), None, padding=2)
            + conv.bias.to(dt)[:, None, None])


LOWERINGS = {
    "resize": lambda conv, h, dt: vae._conv(
        conv, F.interpolate(h, scale_factor=2, mode="nearest"), dt),
    "merged": vae._upconv,
    "dilated": _dilated,
}


def forward(dec: ConvDecoder, z: torch.Tensor, how: str) -> torch.Tensor:
    """ConvDecoder.forward with the lowering `how`, in the decoder's dtype."""
    dt = dec.dtype
    h = F.elu(vae._dense(dec.dense, z, dt))
    h = h.reshape(z.shape[0], dec.h0, dec.w0, dec.f0).permute(0, 3, 1, 2)
    for conv in dec.convs:
        h = F.elu(LOWERINGS[how](conv, h, dt))
    return vae._conv(dec.out, h, dt).permute(0, 2, 3, 1).float()


@contextlib.contextmanager
def lowering(how: str):
    """ConvDecoder runs `how` in every dtype inside the block."""
    saved = ConvDecoder.forward
    ConvDecoder.forward = lambda self, z: forward(self, z, how)
    try:
        yield
    finally:
        ConvDecoder.forward = saved


def per_call_ms(fn, calls: int = 20, repeats: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / calls)
    return statistics.median(out)


def dec_holder(dec: ConvDecoder) -> torch.nn.Module:
    """flax_init_ walks a tree with a `decoder`: wrap the decoder alone."""
    holder = torch.nn.Module()
    holder.decoder = dec
    return holder


def decoder_times(device) -> None:
    for name, (shape, zdim, bs) in SHAPES.items():
        dec = ConvDecoder(zdim, shape, FEATURES, "subpixel").to(device)
        vae.flax_init_(dec_holder(dec), 0)
        gen = np.random.default_rng(0)
        z = torch.tensor(gen.standard_normal((bs, zdim)), dtype=torch.float32, device=device)
        zs = torch.tensor(gen.standard_normal((SERVE_BATCH, zdim)), dtype=torch.float32,
                          device=device)
        C = torch.tensor(gen.standard_normal((bs, *shape)), dtype=torch.float32, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            dec.dtype = dtype
            with torch.no_grad():
                own = dec(zs)
                runs = [how for how in LOWERINGS if torch.equal(own, forward(dec, zs, how))]
            row = {"kind": "decoder", "shape": name, "dtype": str(dtype).split(".")[1],
                   "module_runs": runs}
            for how in LOWERINGS:
                def step():
                    dec.zero_grad(set_to_none=True)
                    torch.sum(forward(dec, z, how) * C).backward()

                def serve():
                    with torch.no_grad():
                        forward(dec, zs, how)

                row[f"{how}_train_ms"] = per_call_ms(step)
                row[f"{how}_serve_ms"] = per_call_ms(serve)
            emit(row)


def epoch_times(device, rounds: int) -> None:
    from gppvae_tpu_torch.config import build_dataset_from_flag
    from gppvae_tpu_torch.train import train_gppvae as tg
    from gppvae_tpu_torch.utils import NullLogger

    for name, (data, train, skip) in EPOCH_RUNS.items():
        ds = build_dataset_from_flag(data["source"], data["num_objects"], data["num_views"],
                                     data["seed"], image_size=data["image_size"])
        secs = {"resize": [], "merged": []}
        oos = {"resize": [], "merged": []}
        for _ in range(rounds):
            for key in ("resize", "merged", "merged", "resize"):
                with lowering(key):
                    res = tg.train_gppvae(ds, tg.GPPVAETrainConfig(**train), device=device,
                                          log=NullLogger())
                secs[key].append([h["sec_epoch"] for h in res.history[skip:]])
                oos[key].append(res.history[-1]["oos_mse"])
        row = {"kind": "epoch", "shape": name, "dtype": "float32", "epochs": train["epochs"],
               "skip": skip}
        for key, runs in secs.items():
            row[key] = [dict(median=statistics.median(s), min=min(s), spread=max(s) / min(s))
                        for s in runs]
            row[f"{key}_mean_median"] = statistics.fmean(r["median"] for r in row[key])
            row[f"{key}_oos_mse"] = oos[key]
        emit(row)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=1)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch_subpixel_lowering.py times the GPU; CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    set_float32_precision("float32")
    device = torch.device("cuda")
    decoder_times(device)
    epoch_times(device, args.rounds)


if __name__ == "__main__":
    main()
