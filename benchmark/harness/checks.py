"""The numbers that decide `correct`, each held to its limit.

Every number is a gap between what the timed path produced and what the
plain reference (benchmark/reference/, float64) gives for the same inputs:

  latent_gap       Phase A: ‖Z − Z_ref‖ / ‖Z_ref‖ of the latent means
  nll_gap          Phase B: |NLL − NLL_ref| / |NLL_ref|, each side at the
                   latents its own Phase A gave
  taylor_gap       Phase B: the worst Taylor coefficient (dZ, dV, d log v_s,
                   d log v_n) by ‖c − c_ref‖ / max(‖c_ref‖, the median ‖c_ref‖),
                   each side at its own latents
  step_loss_gap    the worst of the first steps' |loss − loss_ref| / |loss_ref|
  first_loss_gap   the same of the first step alone, which no optimizer step
                   has touched: from the second step on each side carries
                   Adam's first move, lr·g/(|g| + ε) an element, whose sign
                   rounding decides where a gradient is near zero
  first_grad_gap   the worst parameter's |‖g‖ − ‖g_ref‖| / max(‖g_ref‖, the
                   median ‖g_ref‖), g the first step's gradient as Adam got it
  update_gap       the same of each parameter's change after the first steps,
                   over the parameters whose reference gradient is at least a
                   thousandth of the median (the others move by round-off)
  oos_image_gap    max |ŷ − ŷ_ref| of the held-out predictions after the
                   epoch, the reference having followed every step of it
  core_gap         serving: ‖M − M_ref‖ / ‖M_ref‖ of the folded posterior core
  image_gap        serving: max |ŷ − ŷ_ref| over the kept replies
  failed_requests  serving: requests of the window that raised (limit 0)

A limit file (limits/<cell>.json) gives the limit of each number the cell
compares; the run is correct when every one is finite and at most its limit.
"""

from __future__ import annotations

import math

import torch

REF_GRAD_FLOOR = 1e-3  # a leaf under this share of the median reference gradient is left out


def _f64(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to(torch.float64)


def rel(got, want) -> float:
    """‖got − want‖ / ‖want‖."""
    got, want = _f64(got), _f64(want).to(_f64(got).device)
    return float(torch.linalg.norm(got - want) / torch.clamp(torch.linalg.norm(want), min=1e-300))


def worst_leaf(got: dict, want: dict) -> float:
    """max over leaves of ‖got − want‖ / max(‖want‖, the median ‖want‖)."""
    norms = {k: float(torch.linalg.norm(_f64(v))) for k, v in want.items()}
    med = _median(list(norms.values()))
    return max(float(torch.linalg.norm(_f64(got[k]).to(_f64(want[k]).device) - _f64(want[k])))
               / max(norms[k], med, 1e-300) for k in want)


def worst_norm_gap(got: dict, want: dict, keep=None) -> float:
    """max over the leaves in `keep` (all by default) of |‖got‖ − ‖want‖| /
    max(‖want‖, the median ‖want‖)."""
    keep = list(want) if keep is None else keep
    norms = {k: float(torch.linalg.norm(_f64(v))) for k, v in want.items()}
    med = _median([norms[k] for k in keep])
    return max(abs(float(torch.linalg.norm(_f64(got[k]))) - norms[k]) / max(norms[k], med, 1e-300)
               for k in keep)


def moved_leaves(ref_grads: dict) -> list[str]:
    """The leaves whose reference gradient is at least REF_GRAD_FLOOR of the
    median leaf's."""
    norms = {k: float(torch.linalg.norm(_f64(v))) for k, v in ref_grads.items()}
    med = _median(list(norms.values()))
    return [k for k, n in norms.items() if n >= REF_GRAD_FLOOR * med]


def max_abs(got, want) -> float:
    got = _f64(got)
    return float(torch.max(torch.abs(got - _f64(want).to(got.device))))


def _median(xs: list[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    return 0.5 * (xs[(n - 1) // 2] + xs[n // 2]) if n else 0.0


def training_numbers(prog: dict, ref: dict) -> dict:
    """The training cell's numbers from the program's kept readings and the
    reference's (the same keys: Z0, coeffs {value, dZ, dV, dlog_vs, dlog_vn},
    losses, grads, change, y_pred)."""
    pc, rc = prog["coeffs"], ref["coeffs"]
    leaves = ("dZ", "dV", "dlog_vs", "dlog_vn")
    return {
        "latent_gap": rel(prog["Z0"], ref["Z0"]),
        "nll_gap": abs(float(pc["value"]) - float(rc["value"])) / abs(float(rc["value"])),
        "taylor_gap": worst_leaf({k: pc[k] for k in leaves}, {k: rc[k] for k in leaves}),
        "step_loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"],
                                                                  strict=True)),
        "first_loss_gap": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
        "first_grad_gap": worst_norm_gap(prog["grads"], ref["grads"]),
        "update_gap": worst_norm_gap(prog["change"], ref["change"], moved_leaves(ref["grads"])),
        "oos_image_gap": max_abs(prog["y_pred"], ref["y_pred"]),
    }


def serving_numbers(prog: dict, ref: dict) -> dict:
    """The serving cell's numbers: the folded core, and the kept replies
    against the reference's for the same requests (a reply that is missing
    or of another shape, or no reply kept at all, reads as infinitely far)."""
    gap = 0.0 if prog["replies"] else math.inf
    for got, want in zip(prog["replies"], ref["replies"], strict=True):
        if got is None or tuple(got.shape) != tuple(want.shape):
            gap = math.inf
            break
        gap = max(gap, max_abs(torch.as_tensor(got), want))
    return {"core_gap": rel(prog["core"], ref["core"]), "image_gap": gap}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name: every one finite and within its limit (a limit whose number
    the run did not produce fails). A number the limits do not name is not
    compared: it had no reading that a limit could sit below (PERF.md)."""
    table = {k: {"value": numbers.get(k), "limit": lim} for k, lim in sorted(limits.items())}
    ok = bool(table) and all(v["value"] is not None and math.isfinite(v["value"])
                             and v["value"] <= v["limit"] for v in table.values())
    return ok, table
