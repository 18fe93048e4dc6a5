"""The cells' image grids, made on the card from the seed.

Two procedural grids, each the same model as the program's synthetic
generators (gppvae_tpu_torch/data/rotated_digits.py `synthetic_digit3` with
`rotate_bilinear`, gppvae_tpu_torch/data/faceplace.py `synthetic_faces`),
written here once more over whole tensors so that the grid is drawn in a few
calls on the device, and the split of data/dataset.py `make_grid_split`
(numpy). The draws come from torch.Generator and numpy's, not the program's,
so a grid here is not bit-equal to the program's generator for the same seed.
The benchmark owns these files: a later change to the program leaves the
inputs as they are.

Row n of a grid is (object n // Q, view n % Q), as the program's GridDataset
expects.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def sub_seed(seed: int, tag: int) -> int:
    """An independent 63-bit seed of (seed, tag), for any whole number seed."""
    state = np.random.SeedSequence([seed % (1 << 64), tag]).generate_state(1, np.uint64)
    return int(state[0] >> 1)


def generator(seed: int, tag: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def _uniform(g, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device)


def digit_glyphs(num: int, g: torch.Generator, device, hw: int = 28) -> torch.Tensor:
    """(num, hw, hw) '3'-like glyphs: two left-opening arcs with per-glyph
    radius, stroke width, jitter, shear and intensity."""
    u = lambda lo, hi: _uniform(g, num, lo, hi, device)[:, None, None]  # noqa: E731
    r, width, shear = hw * u(0.14, 0.19), u(0.9, 1.8), u(-0.15, 0.15)
    cx = hw / 2 + u(-1.5, 1.5) + r * 0.25
    cy, amp, span = hw / 2 + u(-1.0, 1.0), u(0.75, 1.0), u(2.0, 2.5)
    ax = torch.arange(hw, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    img = torch.zeros(num, hw, hw, device=device)
    for sgn in (-1.0, 1.0):
        dx, dy = xx - (cx + shear * sgn * r), yy - (cy + sgn * r * 0.95)
        dist = torch.abs(torch.sqrt(dx * dx + dy * dy) - r)
        in_arc = torch.abs(torch.atan2(sgn * dy, dx)) < span / 2
        img = img + torch.where(in_arc, torch.exp(-((dist / width) ** 2)), 0.0)
    return torch.clamp(amp * img, 0.0, 1.0)


def rotate(images: torch.Tensor, angle: float) -> torch.Tensor:
    """(B, H, W) rotated counter-clockwise by `angle` about the centre,
    bilinear, zero outside."""
    B, H, W = images.shape
    dev = images.device
    ys = torch.arange(H, dtype=torch.float32, device=dev) - (H - 1) / 2
    xs = torch.arange(W, dtype=torch.float32, device=dev) - (W - 1) / 2
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    c, s = math.cos(angle), math.sin(angle)
    src_x, src_y = c * xx + s * yy, -s * xx + c * yy  # centred pixel units
    grid = torch.stack([src_x / ((W - 1) / 2), src_y / ((H - 1) / 2)], dim=-1)
    return F.grid_sample(images[:, None], grid.expand(B, H, W, 2), mode="bilinear",
                         padding_mode="zeros", align_corners=True)[:, 0]


def rotated_digits(num_objects: int, num_views: int, image_size: int, seed: int,
                   device) -> tuple[torch.Tensor, np.ndarray]:
    """((P·Q, S, S, 1) images, (Q, 1) rotation angles)."""
    g = generator(seed, 1, device)
    glyphs = digit_glyphs(num_objects, g, device)
    pad = image_size - glyphs.shape[1]
    glyphs = F.pad(glyphs, (pad // 2, pad - pad // 2, pad // 2, pad - pad // 2))
    angles = np.linspace(0.0, 2 * np.pi, num_views, endpoint=False).astype(np.float32)
    views = torch.stack([rotate(glyphs, float(a)) for a in angles], dim=1)  # (P, Q, S, S)
    images = torch.clamp(views, 0.0, 1.0).reshape(-1, image_size, image_size, 1)
    return images.contiguous(), angles[:, None]


def faces(num_people: int, num_poses: int, image_size: int, seed: int, device,
          block: int = 64) -> tuple[torch.Tensor, np.ndarray]:
    """((P·Q, S, S, 3) faces, (Q, 1) pose positions in [-1, 1]): identity sets
    head shape, skin, hair, eyes, nose and mouth; pose is a yaw in
    [-60°, 60°] that shifts and squashes the features."""
    g = generator(seed, 2, device)
    P, Q, S = num_people, num_poses, image_size
    u = lambda lo, hi: _uniform(g, P, lo, hi, device)  # noqa: E731
    p = {"head_w": u(0.55, 0.72), "head_h": u(0.72, 0.9),
         "skin": torch.stack([u(0.55, 0.95), u(0.45, 0.75), u(0.35, 0.62)], 1),
         "hair": _uniform(g, P * 3, 0.05, 0.5, device).reshape(P, 3),
         "eye_y": u(-0.28, -0.15), "eye_dx": u(0.2, 0.3), "eye_r": u(0.05, 0.085),
         "mouth_y": u(0.32, 0.45), "mouth_w": u(0.18, 0.3), "nose_len": u(0.12, 0.22),
         "brow": u(0.04, 0.09)}
    ax = torch.linspace(-1, 1, S, device=device)
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    yaws = torch.linspace(-math.pi / 3, math.pi / 3, Q, device=device)
    out = torch.empty(P * Q, S, S, 3, device=device)
    for start in range(0, P, block):
        idx = torch.arange(start, min(start + block, P), device=device)
        out[start * Q:(start + len(idx)) * Q] = _face_block(
            {k: v[idx].repeat_interleave(Q, 0) for k, v in p.items()},
            yaws.repeat(len(idx)), yy, xx)
    return out, np.linspace(-1.0, 1.0, Q, dtype=np.float32)[:, None]


def _face_block(p: dict, yaw: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor):
    """Faces of the rows of `p` (one per image) at the yaws `yaw`."""
    def col(v):
        return v[:, None, None]

    def paint(img, mask, color):
        return torch.where(mask[..., None], color[:, None, None, :], img)

    n, dev = yaw.shape[0], yaw.device
    s, c = col(torch.sin(yaw)), col(torch.clamp(torch.cos(yaw), min=0.35))
    img = (0.12 + 0.05 * yy)[None, :, :, None].expand(n, *yy.shape, 3)
    hx = 0.15 * s
    head = ((xx - hx) / (col(p["head_w"]) * c)) ** 2 + (yy / col(p["head_h"])) ** 2 < 1.0
    img = paint(img, head, p["skin"])
    eye_y, eye_r = col(p["eye_y"]), col(p["eye_r"])
    hairline = head & (yy < eye_y - 0.22 + 0.06 * torch.cos(3 * xx * math.pi))
    img = paint(img, hairline, p["hair"])
    fx = hx + 0.55 * s * col(p["head_w"])
    white = torch.tensor([0.95, 0.95, 0.95], device=dev).expand(n, 3)
    dark = torch.tensor([0.08, 0.08, 0.1], device=dev).expand(n, 3)
    for sgn in (-1.0, 1.0):
        ex = fx + sgn * col(p["eye_dx"]) * c
        vis = (sgn * s) < 0.85  # the far eye disappears in profile
        eye = (xx - ex) ** 2 / c**2 + (yy - eye_y) ** 2 < eye_r**2
        img = paint(img, eye & head & vis, white)
        pupil = (xx - ex - 0.2 * eye_r * s) ** 2 / c**2 + (yy - eye_y) ** 2 < (0.45 * eye_r) ** 2
        img = paint(img, pupil & head & vis, dark)
        brows = ((torch.abs(yy - (eye_y - 1.8 * eye_r)) < col(p["brow"]) / 2)
                 & (torch.abs(xx - ex) < 1.6 * eye_r * c))
        img = paint(img, brows & head & vis, p["hair"])
    nose = ((torch.abs(xx - fx - 0.02 * s) < 0.025) & (yy > eye_y + 0.08)
            & (yy < eye_y + 0.08 + col(p["nose_len"])))
    img = paint(img, nose & head, p["skin"] * 0.75)
    mouth = (torch.abs(yy - col(p["mouth_y"])) < 0.035) & (torch.abs(xx - fx) < col(p["mouth_w"]) * c)
    img = paint(img, mouth & head, torch.tensor([0.6, 0.2, 0.25], device=dev).expand(n, 3))
    return torch.clamp(img, 0.0, 1.0)


def grid_split(P: int, Q: int, seed: int, heldout_per_object: int = 1,
               val_fraction: float = 0.05) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(train, val, held-out) rows: per object `heldout_per_object` random
    views held out; of the rest a random `val_fraction` for validation,
    keeping at least one training view per object; the remainder trains.
    Every seed gives the same counts."""
    rng = np.random.default_rng(sub_seed(seed, 3))
    if not 0 <= heldout_per_object < Q:
        raise ValueError(f"heldout_per_object={heldout_per_object} must leave a view (Q={Q})")
    heldout = np.zeros(P * Q, dtype=bool)
    for d in range(P):
        heldout[d * Q + rng.choice(Q, size=heldout_per_object, replace=False)] = True
    rest = np.flatnonzero(~heldout)
    rng.shuffle(rest)
    val = np.zeros(P * Q, dtype=bool)
    val[rest[:int(round(val_fraction * len(rest)))]] = True
    for d in range(P):
        rows = np.arange(d * Q, (d + 1) * Q)
        trainable = ~heldout[rows]
        if trainable.any() and val[rows[trainable]].all():
            val[rows[trainable][0]] = False
    return (np.flatnonzero(~heldout & ~val).astype(np.int32),
            np.flatnonzero(val).astype(np.int32), np.flatnonzero(heldout).astype(np.int32))


GRIDS = {"rotated_digits": rotated_digits, "faces": faces}


def make_grid(data: dict, seed: int, device) -> dict:
    """A configuration's `data` block drawn from `seed`: the images on the
    device, the view auxiliary, whether views are periodic, and the split."""
    kind = data["kind"]
    if kind not in GRIDS:
        raise ValueError(f"unknown grid {kind!r}; want one of {sorted(GRIDS)}")
    P, Q = data["num_objects"], data["num_views"]
    images, aux = GRIDS[kind](P, Q, data["image_size"], seed, device)
    train, val, heldout = grid_split(P, Q, seed, data["heldout_per_object"], data["val_fraction"])
    return {"images": images, "view_aux": aux, "periodic_views": kind == "rotated_digits",
            "train_idx": train, "val_idx": val, "heldout_idx": heldout,
            "object_ids": np.repeat(np.arange(P, dtype=np.int32), Q),
            "view_ids": np.tile(np.arange(Q, dtype=np.int32), P)}
