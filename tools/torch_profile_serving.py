"""Profile the port's sustained serving chain on the GPU.

    python tools/torch_profile_serving.py [--data synthetic|faces]
        [--dtype float32|bfloat16] [--batch 200] [--chain 20]

Folds a server state (eval/serving.build_server_state) from a freshly
initialized model (weights from seed 0) at the width of chip_smoke.py's
paths: synthetic rotated digits (P = 400, Q = 16, 32², zdim 16, R = 56) or
faces (P = 50, Q = 8, 128², zdim 32, rbf with 32 RFF features and an
object effect, R = 232). Then, for a --batch-image request batch tiled
from the held-out cells, it runs `serve --sustained`'s chain (--chain
rotated batches back to back, one checksum readback):

  1. the rate, as `serve --sustained` reports it (best of three chains);
  2. one chain under torch.profiler with CUDA activity only: GPU kernel
     time over the wall of that chain, the device-busy share;
  3. one chain under torch.profiler with CPU and CUDA activity: the 12 ops
     with the most device time and the 12 with the most host (self CPU)
     time, and the chrome trace written to --out.

Needs CUDA; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gppvae_tpu_torch.config import build_dataset_from_flag  # noqa: E402
from gppvae_tpu_torch.eval import serving  # noqa: E402
from gppvae_tpu_torch.train import train_gppvae as tg  # noqa: E402
from gppvae_tpu_torch.train.device import COMPUTE_DTYPES, set_float32_precision  # noqa: E402
from torch_profile_epoch import kernel_seconds  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", default="synthetic", choices=["synthetic", "faces"])
    p.add_argument("--dtype", default="float32", choices=list(COMPUTE_DTYPES))
    p.add_argument("--batch", type=int, default=200)
    p.add_argument("--chain", type=int, default=20)
    p.add_argument("--out", default="out/torch_profile_serving.json")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch_profile_serving.py profiles the GPU; CUDA is not available")
    device = torch.device("cuda")
    set_float32_precision("float32")
    if args.data == "faces":
        ds = build_dataset_from_flag("faces", 50, 8, 0, image_size=128)
        cfg = tg.GPPVAETrainConfig(zdim=32, compute_dtype=args.dtype, object_kernel="rbf",
                                   rff_features=32, extra_effects=("object",))
    else:
        ds = build_dataset_from_flag("synthetic", 400, 16, 0)
        cfg = tg.GPPVAETrainConfig(compute_dtype=args.dtype)
    model, gp_params, fixed_W, data, _ = tg._setup(ds, cfg, device)
    x_map, _ = tg._object_kernel(cfg, gp_params["X"], {}, device)
    params = {"vae": model.state_dict(), "gp": {k: v.detach() for k, v in gp_params.items()}}
    extra = cfg.extra_effects
    state = serving.build_server_state(model, params, fixed_W, data["images_tr"], data["d_tr"],
                                       data["q_tr"], x_map=x_map, extra_effects=extra)
    rows = np.tile(ds.heldout_idx, -(-args.batch // len(ds.heldout_idx)))[:args.batch]
    d = torch.as_tensor(ds.object_ids[rows], dtype=torch.int64, device=device)
    q = torch.as_tensor(ds.view_ids[rows], dtype=torch.int64, device=device)
    P, Q = ds.num_objects, ds.num_views

    def call(dd, qq):
        return serving.predict_images(model, state, dd, qq, x_map=x_map, extra_effects=extra)

    def chain() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sums = [call((d + i) % P, (q + i) % Q).sum(dim=(1, 2, 3)) for i in range(args.chain)]
        torch.stack(sums).cpu()
        return time.perf_counter() - t0

    print(f"device {torch.cuda.get_device_name(0)}; {args.data} {ds.image_shape}, "
          f"R = {state.core.M.shape[0]}, {args.dtype}; {args.chain} batches of {args.batch}")
    print(f"serve --sustained: {serving._sustained_throughput(call, d, q, P, Q, args.chain)}")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = chain()
    busy = kernel_seconds(prof.key_averages())
    print(f"CUDA-only profiler: chain wall {wall:.6f} s; GPU kernel time {busy:.6f} s; "
          f"device busy share {busy / wall:.4f}; {args.chain * args.batch / wall:.0f} images/s")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = chain()
    events = prof.key_averages()
    busy = kernel_seconds(events)
    print(f"CPU+CUDA profiler: chain wall {wall:.6f} s; GPU kernel time {busy:.6f} s; "
          f"device busy share {busy / wall:.4f}")
    print(events.table(sort_by="self_device_time_total", row_limit=12))
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    prof.export_chrome_trace(args.out)


if __name__ == "__main__":
    main()
