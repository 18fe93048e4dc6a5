"""Nested dicts of tensors on disk, with a format-version sidecar.

Counterpart of gppvae_tpu/checkpoint/orbax_io.py in the port's own format:
`torch.save` of the tree (tensors moved to the CPU), read back with
`torch.load(weights_only=True)`, which unpickles tensors, containers and
plain values only. Beside each file, `<path>.format.json` records
FORMAT_VERSION; a file written under another version, or whose sidecar is
missing or unreadable, fails with a CheckpointFormatError that names the
version found and the version wanted.

Format history:
  v1 (current): a torch.save'd nested dict of CPU tensors.
"""

from __future__ import annotations

import json
import os
import pickle
import zipfile

import torch

FORMAT_VERSION = 1


class CheckpointFormatError(RuntimeError):
    """A tree was written under an incompatible or unknown format."""


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def save_tree(path: str, tree) -> None:
    """Save a nested dict of tensors (and lists, tuples, numbers, strings,
    None) to `path`, plus the `<path>.format.json` sidecar."""
    path = _abs(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(_to_cpu(tree), path)
    with open(path + ".format.json", "w") as f:
        json.dump({"format_version": FORMAT_VERSION}, f)


def load_tree(path: str, map_location=None):
    """Restore a tree written by save_tree, its tensors on `map_location`
    (default: the CPU). The sidecar is checked first."""
    path = _abs(path)
    sidecar = path + ".format.json"
    try:
        with open(sidecar) as f:
            version = json.load(f).get("format_version")
    except FileNotFoundError:
        raise CheckpointFormatError(
            f"checkpoint {path!r} has no format sidecar {sidecar!r}; this "
            f"build reads format v{FORMAT_VERSION} and records it there. "
            "Restore the sidecar next to the file, or re-save the tree."
        ) from None
    except (OSError, json.JSONDecodeError, AttributeError) as e:
        raise CheckpointFormatError(
            f"checkpoint {path!r} has an unreadable format sidecar "
            f"{sidecar!r} ({e}); it may be a partial write. This build "
            f"reads format v{FORMAT_VERSION}."
        ) from e
    if version != FORMAT_VERSION:
        raise CheckpointFormatError(
            f"checkpoint {path!r} records format_version={version}, but "
            f"this build reads v{FORMAT_VERSION}. Re-save the tree with the "
            "build that wrote it."
        )
    try:
        return torch.load(path, map_location=map_location or "cpu", weights_only=True)
    except (pickle.UnpicklingError, zipfile.BadZipFile, RuntimeError, EOFError) as e:
        raise CheckpointFormatError(
            f"failed to restore {path!r} as a format v{FORMAT_VERSION} tree "
            f"of tensors: {e}"
        ) from e
