"""BENCHMARK.json, and the files it names by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix;
each is found by its name alone:

  configuration      the file its `configs` entry gives (configs/<name>.json)
  reference          the module at the configuration's `reference` path
                     (reference/<name>.py): the model's plain reference,
                     its parameters' shapes and its FLOP count
  traffic mix        traffic/<traffic>.json
  limits             limits/<cell>.json, each compared number's limit
  metric             metrics/<metric>.py, a module with read(run) → float
                     or None (None: nothing to read in this run, and the
                     metric is left out of the line)

A reference module exports

  vae_shapes(model, image_shape) -> {name: shape}
      every VAE parameter, in draw order, under the program's state_dict
      names; `model` is the configuration's whole `model` dict
  vae_flops(model, image_shape) -> (encoder_fwd, decoder_fwd)
      the forward FLOP of one image (yardstick/flops.py's convention:
      1 MAC = 2 FLOP, backward = 2x forward)
  GPPVAE(cfg, image_shape, vae, gp, precision)
      the model both comparisons run (means, taylor, follow, core,
      predict, images)

and imports nothing of the program. The loaded configuration carries its
module under `reference_module`.

A metric belongs to a cell when its `workloads` lists the cell, or, without
that key, when it is an end-to-end metric or moves one that the cell
reports. So a later change adds a cell, a mix, a configuration (with a model
of its own: its reference module) or a metric by adding files and entries,
and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


class Manifest:
    def __init__(self, path: Path = ROOT / "BENCHMARK.json", bench: Path = BENCH):
        self.path, self.bench = Path(path), Path(bench)
        self.doc = json.loads(self.path.read_text())

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}; have "
                       + ", ".join(w["name"] for w in self.doc["workloads"]))

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                cfg = json.loads((self.path.parent / c["file"]).read_text())
                return {**cfg, "name": name, "reference_module": self.reference(cfg)}
        raise KeyError(f"no config {name!r} in {self.path}")

    def _json(self, folder: str, name: str) -> dict:
        return json.loads((self.bench / folder / f"{name}.json").read_text())

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("limits", cell)

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics (untraced) or per-layer ones (traced)."""
        e2e = [m for m in self.doc["end_to_end"] if cell in m.get("workloads", [cell])]
        if not traced:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.doc["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in names else [])]

    def reference(self, cfg: dict):
        """The module at the configuration's `reference` path (relative to
        BENCHMARK.json's folder), loaded by file location."""
        path = self.path.parent / cfg["reference"]
        return _load("benchmark_reference_" + path.stem, path)

    def reader(self, metric: str):
        """metrics/<metric>.py's read function."""
        return _load("benchmark_metric_" + metric, self.bench / "metrics" / f"{metric}.py").read


def _load(name: str, path: Path):
    """The module at `path`, executed under `name` (dots and dashes made
    underscores)."""
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
