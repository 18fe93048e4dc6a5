"""Dataset-builder CLI: build a GridDataset once and store it as .npz.

The port's copy of gppvae_tpu/data/build_cli.py:

    python -m gppvae_tpu_torch build-data --data synthetic --out ds.npz
    python -m gppvae_tpu_torch build-data --data mnist:/path/to/idx \
        --num_objects 400 --num_views 16 --out rot.npz

The .npz is a complete GridDataset (images, object/view ids, view
auxiliary, train/val/heldout splits) that every trainer and eval CLI takes
as `--data npz:<path>`.
"""

from __future__ import annotations

import json


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Build + store a GridDataset")
    p.add_argument("--data", default="synthetic",
                   help="synthetic | sklearn | mnist:<dir> | faces[:h5:<path>]")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--num_objects", type=int, default=400)
    p.add_argument("--num_views", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--image_size", type=int, default=None,
                   help="spatial size (default: builder's own)")
    args = p.parse_args(argv)

    if args.data.startswith("npz:"):
        raise SystemExit("build-data: --data npz:<path> is already built")

    from gppvae_tpu_torch.config import build_dataset_from_flag

    ds = build_dataset_from_flag(
        args.data, args.num_objects, args.num_views, args.seed,
        image_size=args.image_size,
    )
    ds.save_npz(args.out)
    print(json.dumps({
        "out": args.out, "name": ds.name,
        "num_objects": int(ds.num_objects), "num_views": int(ds.num_views),
        "image_shape": list(ds.image_shape),
        "n_train": int(len(ds.train_idx)), "n_val": int(len(ds.val_idx)),
        "n_heldout": int(len(ds.heldout_idx)),
    }))


if __name__ == "__main__":
    main()
