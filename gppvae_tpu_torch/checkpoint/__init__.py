"""The port's checkpoint format: nested dicts of tensors through torch.save,
with a format-version sidecar (counterpart of gppvae_tpu.checkpoint).

The trainers' states (train_gppvae's state_NNNN and final_state, which
`--resume` reads; train_vae's and train_cvae's final_state) and the serving
artifact (eval/serving.py) are written through save_tree.
"""

from gppvae_tpu_torch.checkpoint.tree_io import (
    FORMAT_VERSION,
    CheckpointFormatError,
    load_tree,
    save_tree,
)

__all__ = ["CheckpointFormatError", "FORMAT_VERSION", "load_tree", "save_tree"]
