"""The system under test, gppvae_tpu_torch, as the benchmark drives it.

The only module of the benchmark that imports the program. It hands the
program the inputs the benchmark made (a GridDataset of the grid, the
initial parameters, each epoch's draws) through the program's own entry
points, and reads back what the program produced.

Training calls the public entry train_gppvae.train_gppvae once, with the
initial parameters as `init_params`, each epoch's draws as `draws` and a
log that sees each epoch's record: every epoch, Phase A, B, C, the held-out
prediction and the entry's own work around them, runs as a user's run does.
Serving folds `eval.serving.build_server_state` and answers with
`eval.serving.predict_images`, as `serve --state` does.
"""

from __future__ import annotations

import dataclasses
import inspect
import time

import numpy as np
import torch

from gppvae_tpu_torch.data import GridDataset
from gppvae_tpu_torch.eval.serving import build_server_state, predict_images
from gppvae_tpu_torch.models import VAE
from gppvae_tpu_torch.train import train_gppvae as tg
from gppvae_tpu_torch.train.device import compute_dtype, set_float32_precision
from gppvae_tpu_torch.utils.metrics import NullLogger


def dataset(grid: dict, name: str) -> GridDataset:
    return GridDataset(
        images=grid["images"].cpu().numpy(), object_ids=grid["object_ids"],
        view_ids=grid["view_ids"], view_aux=grid["view_aux"], train_idx=grid["train_idx"],
        val_idx=grid["val_idx"], heldout_idx=grid["heldout_idx"], name=name,
        periodic_views=grid["periodic_views"])


def train_config(cfg: dict, overrides: dict) -> tg.GPPVAETrainConfig:
    model, train = cfg["model"], {**cfg["train"], **overrides}
    fields = {f.name for f in dataclasses.fields(tg.GPPVAETrainConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in {**model, **train}.items() if k in fields}
    return tg.GPPVAETrainConfig(**kw)


CHECKED_HOOKS = ("encode", "solve", "minibatch_step", "oos")


class WindowClosed(Exception):
    """Raised from the trainer's log to end train_gppvae once the run has
    measured what it measures."""


class _Log(NullLogger):
    """The trainer's log: each epoch's record goes to `on_record`."""

    def __init__(self, on_record):
        super().__init__()
        self.on_record = on_record

    def log(self, record) -> None:
        self.on_record(record)


class Trainer:
    """train_gppvae.train_gppvae, the public entry, over the benchmark's
    inputs: `init_params` the initial parameters, `draws` each epoch's
    plan and noise, `log` a callback that sees each epoch's record as the
    entry logs it and ends the run by raising WindowClosed. One call trains
    one model from its first epoch to the last that the run needs.

    The first epoch is checked: hooks on the entry's epoch loop (`_Loop`,
    the object the entry builds) keep what that epoch produced for the
    comparison, and are taken off once its record is logged. `fault`, a
    function of harness/faults.py, is planted in that loop as it is built."""

    def __init__(self, ds: GridDataset, config: tg.GPPVAETrainConfig, vae: dict, gp: dict,
                 device: torch.device, checked_steps: int, fault=None):
        self.ds, self.device, self.fault = ds, device, fault
        self.config = dataclasses.replace(config, epochs=2**62, outdir=None)
        self.init = {"vae": {k: v.cpu() for k, v in vae.items()},
                     "gp": {k: v.cpu().numpy() for k, v in gp.items()}}
        self.checked_steps = checked_steps
        self.loop = None
        self.built_at = None  # perf_counter() when the entry had built its loop
        self.kept: dict = {"losses": []}

    def run(self, draws, on_record) -> None:
        """Train until `on_record(record)` raises WindowClosed."""
        build = tg._Loop.__init__
        trainer = self

        def built(loop, *args, **kwargs):
            build(loop, *args, **kwargs)
            tg._Loop.__init__ = build
            trainer.loop = loop
            if trainer.fault:
                trainer.fault(trainer)
            trainer._keep_checked_epoch()
            trainer.built_at = time.perf_counter()

        def logged(record):
            if record["epoch"] == 0:
                self._release_checked_epoch()
            on_record(record)

        tg._Loop.__init__ = built
        try:
            tg.train_gppvae(self.ds, self.config, device=self.device, init_params=self.init,
                            draws=draws, log=_Log(logged))
        except WindowClosed:
            pass
        finally:
            tg._Loop.__init__ = build

    def skipped_steps(self) -> int:
        """Optimizer steps the guard skipped as not finite, so far."""
        return self.loop.opt_vae.notfinite_count + self.loop.opt_gp.notfinite_count

    def params(self) -> tuple[dict, dict]:
        """Copies of the VAE's and the GP's parameters, by name."""
        loop = self.loop
        return ({k: v.detach().clone() for k, v in loop.model.state_dict().items()},
                {k: v.detach().clone() for k, v in loop.gp.items()})

    def first_gradients(self) -> dict:
        """Each parameter's gradient as the optimizer got it on its first
        step, from its state after that step: Adam's first moment is
        (1 − β1)·g then."""
        loop = self.loop
        names = [*(k for k, _ in loop.model.named_parameters()),
                 *(f"gp.{k}" for k in sorted(loop.gp))]
        params = [*loop.opt_vae.params, *loop.opt_gp.params]
        out = {}
        for name, p in zip(names, params):
            st = loop.opt_vae.adam.state.get(p) or loop.opt_gp.adam.state.get(p)
            out[name] = (st["exp_avg"].detach() / (1.0 - 0.9) if st and "exp_avg" in st
                         else torch.zeros_like(p))
        return out

    def _keep_checked_epoch(self) -> None:
        """Hooks that keep what the first epoch produced: Phase A's
        latents, Phase B's NLL and Taylor coefficients, the loss of each of
        the first `checked_steps` minibatch steps, the gradients of the
        first, the parameters after `checked_steps` steps, and the
        held-out predictions."""
        loop, kept, steps = self.loop, self.kept, self.checked_steps
        self._unhooked = {h: getattr(loop, h) for h in CHECKED_HOOKS}
        encode, solve, step, oos = (self._unhooked[h] for h in CHECKED_HOOKS)

        def encode_kept():
            Z = encode()
            kept.setdefault("Z0", Z.detach().clone())
            return Z

        def solve_kept(Z0):
            c = solve(Z0)
            dV = torch.cat(list(c.dV), dim=1) if isinstance(c.dV, (list, tuple)) else c.dV
            kept.setdefault("coeffs", {"value": c.value.clone(), "dZ": c.dZ.clone(),
                                       "dV": dV.clone(), "dlog_vs": c.daux["log_vs"].clone(),
                                       "dlog_vn": c.daux["log_vn"].clone()})
            return c

        def step_kept(*args):
            metrics = step(*args)
            if len(kept["losses"]) < steps:
                kept["losses"].append(float(metrics[0]))
                if len(kept["losses"]) == 1:
                    kept["grads"] = {k: v.clone() for k, v in self.first_gradients().items()}
                if len(kept["losses"]) == steps:
                    kept["after_steps"] = self.params()
            return metrics

        def oos_kept(Z):
            y_pred, mse = oos(Z)
            kept.setdefault("y_pred", y_pred.detach().clone())
            return y_pred, mse

        loop.encode, loop.solve, loop.minibatch_step, loop.oos = (
            encode_kept, solve_kept, step_kept, oos_kept)

    def _release_checked_epoch(self) -> None:
        for hook, fn in self._unhooked.items():
            setattr(self.loop, hook, fn)


def vae_options(model: dict, given) -> dict:
    """The keys of a configuration's `model` that the program's VAE
    constructor names, other than those in `given`: a model option the
    program gains reaches the served model as it reaches the trainer's
    config (train_config)."""
    names = set(inspect.signature(VAE).parameters) - set(given)
    return {k: tuple(v) if isinstance(v, list) else v for k, v in model.items() if k in names}


class Server:
    """A served model: the state folded once, then one call per request."""

    def __init__(self, ds: GridDataset, config: tg.GPPVAETrainConfig, model: dict, vae: dict,
                 gp: dict, device: torch.device):
        """`model`: the configuration's `model` dict."""
        set_float32_precision(config.compute_dtype)
        given = {"zdim": config.zdim, "image_shape": ds.image_shape,
                 "enc_features": config.enc_features, "dec_features": config.dec_features,
                 "upsample": config.dec_upsample, "dtype": compute_dtype(config.compute_dtype)}
        self.model = VAE(**given, **vae_options(model, given))
        self.model.load_state_dict({k: v.cpu() for k, v in vae.items()})
        self.model.to(device)
        self.gp = {k: v.detach().clone() for k, v in gp.items()}
        tr = ds.train_idx
        rows = lambda a: torch.as_tensor(a[tr], dtype=torch.int64, device=device)  # noqa: E731
        self.state = build_server_state(
            self.model, {"vae": self.model.state_dict(), "gp": self.gp}, None,
            torch.from_numpy(ds.images[tr]).to(device), rows(ds.object_ids),
            rows(ds.view_ids))
        self.device = device

    def request(self, d: np.ndarray, q: np.ndarray) -> np.ndarray:
        """One request's images in host memory, as `serve --state` hands
        them back."""
        dd = torch.as_tensor(d, dtype=torch.int64, device=self.device)
        qq = torch.as_tensor(q, dtype=torch.int64, device=self.device)
        return predict_images(self.model, self.state, dd, qq).cpu().numpy()

    def core(self) -> torch.Tensor:
        """The posterior core M that the fold produced."""
        return self.state.core.M.detach().clone()

