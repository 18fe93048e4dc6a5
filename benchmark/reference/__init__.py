"""The plain references, one module per model, each named by a
configuration's `reference` and loaded by file location
(harness/manifest.py): plain PyTorch, no kernels, imports nothing of the
program."""
