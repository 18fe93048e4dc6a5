"""Protocol-aware diff of two bench_torch.py artifacts.

The twin of tools/bench_diff.py for the port's bench. A wall-clock delta is
evidence of a regression only where the two runs are the same measurement:

- a row's identity is its config name, its `model_dtype`, its batch
  (`serving_batch` or `batch`) and the card it ran on: the name and the
  power limit in `extra.device` (a card set below 700 W runs slower under
  load). The port has no program hash to arbitrate by;
- slower beyond the drift band (DEFAULT_DRIFT on `sec_epoch_min`, on the
  headline `value`, and on the sustained serving rates) is a regression at
  the same identity and non-comparable at another (another card or power
  limit, dtype or batch); a serving rate at another identity is
  non-comparable whatever its value, as in tools/bench_diff.py;
- the verdicts must hold whatever the wall: `verdict` PASS → anything else
  and `win_ok` true → false are regressions.

    python tools/torch_bench_diff.py OLD NEW [--drift 0.15]

Each of OLD, NEW is an artifact line (`{"metric": ...}`), a run record's
`{"cmd", "rc", "parsed", "tail"}` wrapper, or a log whose last artifact line
is taken (tools/bench_diff.py's load_artifact). Exit status: 0 no
regression, 1 at least one, 2 an input that holds no artifact.
"""

from __future__ import annotations

import argparse
import json
import sys

# the three forms of input are read as tools/bench_diff.py reads them; its
# load_artifact ends in SystemExit on an input that holds no artifact
from bench_diff import load_artifact

# tools/bench_diff.py's band. sec/epoch spreads up to 1.6× between calls on
# the same card type, on the host's account (PERF.md), so a flagged row is
# believed only once both trees ran in one call
DEFAULT_DRIFT = 0.15

SUSTAINED_KEYS = ("serving_sustained_b200_images_per_sec", "sustained_images_per_sec")


def card(art: dict):
    """(name, the nvidia-smi `name, power.limit` line), or "cpu"."""
    dev = art.get("extra", {}).get("device")
    if isinstance(dev, dict):
        return (dev.get("name"), dev.get("nvidia_smi"))
    return dev


def identity(name: str, row: dict, art: dict) -> tuple:
    return (name, row.get("model_dtype"), row.get("serving_batch", row.get("batch")), card(art))


def _cfgs(art: dict) -> dict:
    return art.get("extra", {}).get("configs", {}) or {}


def diff(old: dict, new: dict, drift: float = DEFAULT_DRIFT) -> dict:
    """Compare two artifacts; returns the verdict summary dict."""
    regressions: list[str] = []
    non_comparable: list[str] = []
    ok_lines: list[str] = []
    same_card = card(old) == card(new)

    def compare(tag: str, same: bool, slower: bool, ids, serving: bool = False) -> None:
        if serving and not same:  # a rate is read only at its own protocol
            non_comparable.append(f"{tag}: NOT comparable, identity {ids[0]} vs {ids[1]}")
        elif not slower:
            ok_lines.append(f"{tag} [{'same identity' if same else 'within the band'}]")
        elif same:
            regressions.append(f"{tag} beyond the {drift:.0%} band at identity {ids[1]}")
        else:
            non_comparable.append(f"{tag}: NOT comparable, identity {ids[0]} vs {ids[1]}")

    ov, nv = old.get("value"), new.get("value")
    if isinstance(ov, (int, float)) and isinstance(nv, (int, float)) and ov > 0:
        compare(f"headline {old.get('metric')}: {ov} -> {nv} ({nv / ov:.3f}x)", same_card,
                nv / ov > 1 + drift, (card(old), card(new)))

    oc, nc = _cfgs(old), _cfgs(new)
    for name in sorted(set(oc) & set(nc)):
        o, n = oc[name], nc[name]
        if not (isinstance(o, dict) and isinstance(n, dict)):
            continue
        ids = (identity(name, o, old), identity(name, n, new))
        osec = o.get("sec_epoch_min", o.get("sec_epoch"))
        nsec = n.get("sec_epoch_min", n.get("sec_epoch"))
        if isinstance(osec, (int, float)) and isinstance(nsec, (int, float)) and osec > 0:
            compare(f"config {name}: sec_epoch_min {osec} -> {nsec} ({nsec / osec:.2f}x)",
                    ids[0] == ids[1], nsec / osec > 1 + drift, ids)
        key = next((k for k in SUSTAINED_KEYS if k in o and k in n), None)
        if key and o[key] > 0:
            compare(f"config {name}: {key} {o[key]} -> {n[key]} ({n[key] / o[key]:.2f}x)",
                    ids[0] == ids[1], n[key] / o[key] < 1 - drift, ids, serving=True)
        if o.get("verdict") == "PASS" and n.get("verdict") not in (None, "PASS"):
            regressions.append(f"config {name}: verdict PASS -> {n.get('verdict')}")
        if o.get("win_ok") is True and n.get("win_ok") is False:
            regressions.append(f"config {name}: win_ok true -> false")

    return {
        "ok": not regressions,
        "regressions": regressions,
        "non_comparable": non_comparable,
        "comparable_ok": ok_lines,
        "card": {"old": card(old), "new": card(new)},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("old", help="older artifact / run record / log")
    p.add_argument("new", help="newer artifact / run record / log")
    p.add_argument("--drift", type=float, default=DEFAULT_DRIFT,
                   help="relative band treated as run-to-run drift (default 0.15)")
    args = p.parse_args(argv)
    try:
        old, new = load_artifact(args.old), load_artifact(args.new)
    except (OSError, SystemExit) as e:
        print(f"torch_bench_diff: {e}", file=sys.stderr)
        return 2
    summary = diff(old, new, drift=args.drift)
    for k in ("comparable_ok", "non_comparable", "regressions"):
        for line in summary[k]:
            print(f"[{k.upper().rstrip('S').replace('_', ' ')}] {line}")
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
