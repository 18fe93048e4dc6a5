"""Profile GPPVAE-joint epochs of the PyTorch port on the GPU.

    python tools/torch_profile_epoch.py [--epochs_warm 1] [--num_objects 400]
        [--dtype float32|bfloat16] [--dec_upsample resize|subpixel]

Builds the BASELINE GPPVAE-joint shape (synthetic rotated digits, P = 400,
Q = 16, zdim 16, R = 56, bs 128; float32 and the resize decoder unless
--dtype / --dec_upsample say otherwise) with a freshly initialized VAE and
runs the trainer's own epoch (`_Loop.run_epoch`):

  1. warm-up epochs, each with its phase seconds (the first shows what a
     cold epoch costs, and in which phase);
  2. one epoch with no profiler: its wall seconds;
  3. one epoch under torch.profiler with CUDA activity only: GPU kernel time
     over the wall of that same epoch, the device-busy share;
  4. one epoch under torch.profiler with CPU and CUDA activity: the 15 ops
     with the most device time, the 15 with the most host (self CPU) time,
     and the chrome trace written to --out (default
     out/torch_profile_epoch.json).

Needs CUDA; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gppvae_tpu_torch.config import build_dataset_from_flag  # noqa: E402
from gppvae_tpu_torch.train import train_gppvae as tg  # noqa: E402
from gppvae_tpu_torch.train.batching import make_draws  # noqa: E402
from gppvae_tpu_torch.models import UPSAMPLES  # noqa: E402
from gppvae_tpu_torch.train.device import COMPUTE_DTYPES, set_float32_precision  # noqa: E402


def kernel_seconds(events) -> float:
    """GPU kernel time in key_averages() rows. Kernel rows only: an op's row
    and a GPU annotation (Adam.step) repeat the time of the kernels inside."""
    return sum(ev.self_device_time_total for ev in events
               if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation) / 1e6


def timed_epoch(loop, draws, epoch) -> tuple[float, dict]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, phases, _ = loop.run_epoch(draws, epoch)
    return time.perf_counter() - t0, phases


def fmt(phases: dict) -> str:
    return ", ".join(f"{k} {v:.6f}" for k, v in phases.items())


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num_objects", type=int, default=400)
    p.add_argument("--num_views", type=int, default=16)
    p.add_argument("--epochs_warm", type=int, default=1)
    p.add_argument("--dtype", default="float32", choices=list(COMPUTE_DTYPES))
    p.add_argument("--dec_upsample", default="resize", choices=list(UPSAMPLES))
    p.add_argument("--out", default="out/torch_profile_epoch.json")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch_profile_epoch.py profiles the GPU; CUDA is not available")
    device = torch.device("cuda")
    set_float32_precision("float32")
    ds = build_dataset_from_flag("synthetic", args.num_objects, args.num_views, 0)
    cfg = tg.GPPVAETrainConfig(mode="joint", compute_dtype=args.dtype,
                               dec_upsample=args.dec_upsample)
    model, gp_params, fixed_W, data, n = tg._setup(ds, cfg, device)
    loop = tg._Loop(model, gp_params, fixed_W, data, n, cfg)
    draws = make_draws(tg.run_keys(cfg.seed)[0], n, cfg.batch_size, cfg.zdim)
    print(f"device {torch.cuda.get_device_name(0)}; N={n}, steps/epoch={loop.nb}; "
          f"{args.dtype}, {args.dec_upsample} decoder")

    epoch = 0
    for _ in range(args.epochs_warm):
        wall, phases = timed_epoch(loop, draws, epoch)
        print(f"warm-up epoch {epoch}: wall {wall:.6f} s ({fmt(phases)})")
        epoch += 1

    wall, phases = timed_epoch(loop, draws, epoch)
    print(f"epoch {epoch}, no profiler: wall {wall:.6f} s ({fmt(phases)})")
    epoch += 1

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall, phases = timed_epoch(loop, draws, epoch)
    busy = kernel_seconds(prof.key_averages())
    print(f"epoch {epoch}, CUDA-only profiler: wall {wall:.6f} s ({fmt(phases)}); "
          f"GPU kernel time {busy:.6f} s; device busy share {busy / wall:.4f}")
    epoch += 1

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, phases = timed_epoch(loop, draws, epoch)
    events = prof.key_averages()
    busy = kernel_seconds(events)
    print(f"epoch {epoch}, CPU+CUDA profiler: wall {wall:.6f} s ({fmt(phases)}); "
          f"GPU kernel time {busy:.6f} s; device busy share {busy / wall:.4f}")
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    print(events.table(sort_by="self_cpu_time_total", row_limit=15))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    prof.export_chrome_trace(args.out)


if __name__ == "__main__":
    main()
