"""Map the reference-style --data flag onto dataset builders.

The port's copy of gppvae_tpu/config/datasets.py.

Accepted values (SURVEY.md §5 config table; BASELINE.json:7-11 configs):
    synthetic | sklearn | mnist:<dir>   → rotated-digits grid
    faces | faces:h5:<path>             → face-view grid (FacePlace-style)
    npz:<path>                          → any saved GridDataset
"""

from __future__ import annotations

from gppvae_tpu_torch.data import GridDataset, build_faceplace, build_rotated_digits


def build_dataset_from_flag(
    flag: str,
    num_objects: int,
    num_views: int,
    seed: int,
    image_size: int | None = None,
) -> GridDataset:
    """`image_size=None` keeps each builder's default (32² digits, 64²
    faces); an explicit value reaches e.g. the benched face-view 128²
    shape (bench.py config 4) from the CLI."""
    size = {} if image_size is None else {"image_size": image_size}
    if flag.startswith("npz:"):
        ds = GridDataset.load_npz(flag[4:])
        # can't resize a stored artifact — verify instead of silently
        # serving a different shape
        if image_size is not None and ds.image_shape[0] != image_size:
            raise ValueError(
                f"stored dataset {flag!r} is {ds.image_shape[0]}², not the"
                f" requested --image_size {image_size}; rebuild it at that size"
            )
        return ds
    if flag == "faces":
        return build_faceplace(
            "synthetic", num_people=num_objects, num_poses=num_views,
            seed=seed, **size,
        )
    if flag.startswith("faces:"):
        return build_faceplace(flag.split(":", 1)[1], seed=seed, **size)
    return build_rotated_digits(
        flag, num_objects=num_objects, num_views=num_views, seed=seed, **size
    )
