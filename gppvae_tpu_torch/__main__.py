"""Unified CLI: python -m gppvae_tpu_torch <command> [args...]

The twin of `python -m gppvae_tpu`:

    build-data    build + store a GridDataset .npz      (data/build_cli.py)
    train-vae     conv-VAE pretrain                     (train/train_vae.py)
    train-gppvae  GPPVAE dis/joint training             (train/train_gppvae.py)
    train-cvae    CVAE comparison baseline              (train/train_cvae.py)
    generate      out-of-sample conditional generation  (eval/generate.py)
    serve         answer (object, view) requests from an exported
                  server-state artifact                 (eval/serving.py)
    plot          render metrics.jsonl history figure   (eval/plots.py)
"""

import sys

_COMMANDS = {
    "build-data": ("gppvae_tpu_torch.data.build_cli", "main"),
    "train-vae": ("gppvae_tpu_torch.train.train_vae", "main"),
    "train-gppvae": ("gppvae_tpu_torch.train.train_gppvae", "main"),
    "train-cvae": ("gppvae_tpu_torch.train.train_cvae", "main"),
    "generate": ("gppvae_tpu_torch.eval.generate", "main"),
    "serve": ("gppvae_tpu_torch.eval.serving", "main"),
    "plot": ("gppvae_tpu_torch.eval.plots", "main"),
}


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print(__doc__)
        raise SystemExit(0 if len(sys.argv) >= 2 else 1)
    cmd = sys.argv[1]
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}; choose from {sorted(_COMMANDS)}")
        raise SystemExit(2)
    import importlib

    module, fn = _COMMANDS[cmd]
    getattr(importlib.import_module(module), fn)(sys.argv[2:])


if __name__ == "__main__":
    main()
