"""The port's checkpoint format: nested dicts of tensors through torch.save,
with a format-version sidecar (counterpart of gppvae_tpu.checkpoint).

Resume from a full train state is not ported yet (ROADMAP); the serving
artifact (eval/serving.py) is written through save_tree.
"""

from gppvae_tpu_torch.checkpoint.tree_io import (
    FORMAT_VERSION,
    CheckpointFormatError,
    load_tree,
    save_tree,
)

__all__ = ["CheckpointFormatError", "FORMAT_VERSION", "load_tree", "save_tree"]
