"""Data layer: rotated-digits builder, FacePlace loader, split logic.

The port's own copy of gppvae_tpu.data (numpy and the standard library;
sklearn and h5py load only for the sources that need them). The builders
return the same `GridDataset` contract with the same images, ids and splits
as the JAX package's (tests/test_torch_data.py holds them to it): a
grid-complete (object × view) image tensor with integer object/view ids and
a held-out split for out-of-sample evaluation.
"""

from gppvae_tpu_torch.data.dataset import GridDataset
from gppvae_tpu_torch.data.faceplace import build_faceplace
from gppvae_tpu_torch.data.rotated_digits import build_rotated_digits

__all__ = ["GridDataset", "build_faceplace", "build_rotated_digits"]
