"""A cell's run: set-up, the measured window, the traced slice, and the
comparison with the reference once the program's state is freed.

A mix's `kind` picks one of KINDS; everything else a run reads comes from
the configuration (configs/<name>.json, with the reference module it names
under `reference_module`) and the mix (traffic/<name>.json).
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark.harness import checks, datagen, program, trace, traffic, weights


class Run:
    """What one run measured, for the metric readers."""

    def __init__(self, cell: dict, cfg: dict, mix: dict, device: torch.device, seed: int):
        self.cell, self.cfg, self.mix, self.device, self.seed = cell, cfg, mix, device, seed
        self.setup_s = None
        self.setup_parts: dict = {}  # set-up's seconds by part, for the earlier output lines
        self.window_s = None
        self.epochs: list[dict] = []  # training: per window epoch, wall_s and the phases
        self.latencies: list[float] = []  # serving: per window request, seconds
        self.images = 0  # serving: images handed back in the window
        self.attempted = self.failed = 0
        self.slice: trace.Slice | None = None  # the card's activity in the traced slice
        # serving: profile a card-only slice in an untraced run too, for an
        # end-to-end metric read from the device's trace
        self.card_slice = False
        self.slice_images = 0  # serving: images asked in that slice
        self.host_slice: trace.Slice | None = None  # a shorter one with the host's too
        self.memory_peak_bytes = None
        self.numbers: dict = {}
        self.shapes: dict = {}
        self.inputs: tuple = ()  # (grid, vae0, gp0): what both sides were given
        self.produced: dict = {}  # what the timed path produced, for the comparison
        self.ref: dict = {}  # the reference's readings of the same
        self.reference_s = None  # the reference's seconds, after the window


def _ref_config(run: Run) -> dict:
    """The model and training fields the reference reads, as the mix runs them."""
    return {**run.cfg["model"], **run.cfg["train"], **run.mix.get("train", {})}


def _reference_model(run: Run, grid: dict, vae0: dict, gp0: dict, precision: str):
    """The configuration's reference model over the initial parameters."""
    return run.cfg["reference_module"].GPPVAE(_ref_config(run), tuple(grid["images"].shape[1:]),
                                              vae0, gp0, precision)


def _grid_rows(grid: dict, part: str, device):
    idx = torch.as_tensor(grid[part], dtype=torch.int64, device=device)
    return (grid["images"][idx],
            torch.as_tensor(grid["object_ids"][grid[part]], dtype=torch.int64, device=device),
            torch.as_tensor(grid["view_ids"][grid[part]], dtype=torch.int64, device=device))


def _free() -> None:
    """Give the card's memory back once the program's state is dropped."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def inputs(cfg: dict, mix: dict, seed: int, device):
    """The grid, the initial parameters, the program's dataset and config."""
    grid = datagen.make_grid(cfg["data"], seed, device)
    vae0, gp0 = weights.make(cfg["reference_module"], cfg["model"], cfg["train"], grid, seed,
                             device)
    ds = program.dataset(grid, cfg["name"])
    return grid, vae0, gp0, ds, program.train_config(cfg, mix.get("train", {}))


# -- training

def reference(run: Run, precision: str = "exact") -> dict:
    """The reference's readings of what the run's timed path produced, in
    `precision` ('exact', or a configuration's `control`)."""
    ref = reference_training if run.mix["kind"] == "train" else reference_serving
    return ref(run, *run.inputs, precision)


def reference_training(run: Run, grid: dict, vae0: dict, gp0: dict, precision: str) -> dict:
    """The checked epoch, followed whole from the initial parameters on
    the same draws: Phase A; Phase B at the reference's own latents; every
    minibatch step of the epoch (the losses of the first `checked_steps`,
    the first gradients, each parameter's change after those steps); then
    eval's encode and the held-out predictions at the parameters the
    reference reached. Nothing the program made enters it."""
    device, steps, rc = run.device, run.mix["checked_steps"], _ref_config(run)
    draws = traffic.epoch_draws(run.seed, len(grid["train_idx"]), rc["batch_size"], rc["zdim"])
    images, d, q = _grid_rows(grid, "train_idx", device)
    ref = _reference_model(run, grid, vae0, gp0, precision)
    Z0 = ref.means(images)
    coeffs = ref.taylor(Z0, d, q)
    batches, w, eps = draws(0)
    plan = [(batches[s].to(device), w[s].to(device), eps[s].to(device))
            for s in range(batches.shape[0])]
    out = ref.follow(coeffs, images, d, q, plan, images.shape[0], steps)
    M = ref.core(ref.means(images), d, q)
    _, d_ho, q_ho = _grid_rows(grid, "heldout_idx", device)
    return {"Z0": Z0, "coeffs": coeffs, "losses": out["losses"], "grads": out["grads"],
            "change": out["change"], "y_pred": ref.predict(M, d_ho, q_ho)}


def program_readings(kept: dict, vae0: dict, gp0: dict) -> dict:
    vae, gp = kept["after_steps"]
    start = {**vae0, **{f"gp.{k}": v for k, v in gp0.items()}}
    end = {**vae, **{f"gp.{k}": v for k, v in gp.items()}}
    return {**kept, "change": {k: end[k] - start[k] for k in start}}


def gp_rank(config) -> int:
    """R, the columns of U: the object × view product effect's (object
    features, or their RFF or Nyström map, times the view features) and
    each extra effect's."""
    obj = {"linear": config.obj_feature_dim, "rbf": config.rff_features,
           "rbf-nystrom": config.nystrom_rank}[config.object_kernel]
    view = config.view_feature_dim or 2 * config.view_num_freqs + 1
    extra = {"object": config.obj_feature_dim, "view": view}
    return obj * view + sum(extra[e] for e in config.extra_effects)


class _Parts:
    """Seconds of each part of set-up, from the process's start."""

    def __init__(self, run: Run, t_start: float):
        self.run, self.last = run, t_start

    def __call__(self, name: str, at: float | None = None) -> None:
        """The part `name` ended at `at` (perf_counter seconds), or now."""
        at = time.perf_counter() if at is None else at
        self.run.setup_parts[name] = at - self.last
        self.last = at


class _Course:
    """A training run's course, one step per epoch record that the trainer
    logs: the checked epoch and the warm ones are set-up; then the window,
    each epoch timed from the previous record to its own, so that the
    trainer's work between its epochs counts; then, traced, the slices;
    then WindowClosed ends the trainer."""

    def __init__(self, run: Run, trainer, seconds: float, traced: bool, part, t_start: float):
        self.run, self.trainer, self.seconds, self.traced = run, trainer, seconds, traced
        self.part, self.t_start = part, t_start
        self.warm = run.mix["warm_epochs"]
        self.t0 = self.last = self.closed = None
        self.recorder = None

    def __call__(self, record: dict) -> None:
        now = time.perf_counter()
        run, epoch = self.run, record["epoch"]
        if epoch == 0:
            self.part("program", self.trainer.built_at)
            self.part("checked_epoch", now)
        if epoch < self.warm - 1:
            return
        if self.t0 is None:
            self.part("warm_epochs", now)
            run.setup_s = now - self.t_start
            self.t0 = self.last = now
            self.skipped = self.trainer.skipped_steps()
            return
        if self.closed is None:
            phases = {k[4:]: v for k, v in record.items()
                      if k.startswith("sec_") and k != "sec_epoch"}
            run.epochs.append({"wall_s": now - self.last, **phases})
            skipped = self.trainer.skipped_steps()
            run.failed += skipped > self.skipped
            self.skipped, self.last = skipped, now
            if now - self.t0 < self.seconds:
                return
            run.window_s = now - self.t0
            run.attempted = len(run.epochs)
            self.closed = epoch
            if not self.traced:
                raise program.WindowClosed
            self.recorder = trace.Recorder(run.device)
            self.recorder.start()
            return
        n = run.mix["trace_epochs"]
        if epoch == self.closed + n:
            run.slice = self.recorder.stop(n)
            self.recorder = trace.Recorder(run.device, host=True)
            self.recorder.start()
        elif epoch == self.closed + n + 1:
            run.host_slice = self.recorder.stop(1)
            raise program.WindowClosed


def train(run: Run, seconds: float, traced: bool, t_start: float, fault=None) -> None:
    cfg, mix, device, seed = run.cfg, run.mix, run.device, run.seed
    part = _Parts(run, t_start)
    part("start")
    grid, vae0, gp0, ds, config = inputs(cfg, mix, seed, device)
    part("inputs")
    n = len(ds.train_idx)
    run.shapes = {"n_train": n, "n_heldout": len(ds.heldout_idx), "zdim": config.zdim,
                  "rank": gp_rank(config), "batch_size": config.batch_size,
                  "image_shape": ds.image_shape}
    trainer = program.Trainer(ds, config, vae0, gp0, device, mix["checked_steps"], fault)
    trainer.run(traffic.epoch_draws(seed, n, config.batch_size, config.zdim),
                _Course(run, trainer, seconds, traced, part, t_start))
    run.memory_peak_bytes = _peak(device)
    run.inputs, run.produced = (grid, vae0, gp0), program_readings(trainer.kept, vae0, gp0)
    trainer.loop = None
    del trainer
    _free()
    t_ref = time.perf_counter()
    run.ref = reference(run)
    run.reference_s = time.perf_counter() - t_ref
    run.numbers = checks.training_numbers(run.produced, run.ref)


# -- serving

def reference_serving(run: Run, grid: dict, vae0: dict, gp0: dict, precision: str) -> dict:
    """The folded core and the images of each kept request."""
    device = run.device
    images, d, q = _grid_rows(grid, "train_idx", device)
    ref = _reference_model(run, grid, vae0, gp0, precision)
    M = ref.core(ref.means(images), d, q)
    out = [ref.predict(M, torch.as_tensor(dd, device=device), torch.as_tensor(qq, device=device))
           for dd, qq in run.produced["requests"]]
    return {"core": M, "replies": out}


def serve(run: Run, seconds: float, traced: bool, t_start: float, fault=None) -> None:
    cfg, mix, device, seed = run.cfg, run.mix, run.device, run.seed
    part = _Parts(run, t_start)
    part("start")
    grid, vae0, gp0, ds, config = inputs(cfg, mix, seed, device)
    part("inputs")
    server = program.Server(ds, config, cfg["model"], vae0, gp0, device)
    if fault:
        fault(server)
    part("program")
    reqs = traffic.Requests(mix, seed, ds.num_objects, ds.num_views)
    for d, q in reqs.warm_sizes():
        server.request(d, q)
    part("warm_requests")
    run.shapes = {"num_views": ds.num_views, "image_shape": ds.image_shape}
    kept, replies = [], []

    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    end = t0
    while True:
        d, q, checked = reqs.next()
        start = time.perf_counter()
        try:
            y = server.request(d, q)
        except RuntimeError:  # a reply that never comes: counted, and compared as missing
            run.failed += 1
            y = None
        end = time.perf_counter()
        run.attempted += 1
        run.latencies.append(end - start)
        run.images += 0 if y is None else y.shape[0]
        if checked and len(kept) < mix["max_checked"]:
            kept.append((d, q))
            replies.append(y)
        if end - t0 >= seconds:
            break
    run.window_s = end - t0

    def work(requests):
        for d, q in requests:
            server.request(d, q)

    if traced:
        slice_reqs = [reqs.next()[:2] for _ in range(mix["trace_requests"])]
    elif run.card_slice:  # whole blocks: every seed the same sizes
        slice_reqs = reqs.blocks(-(-mix["trace_requests"] // len(reqs.sizes)))
    if traced or run.card_slice:
        run.slice = trace.profile(lambda: work(slice_reqs), len(slice_reqs), device)
        run.slice_images = sum(len(d) for d, _ in slice_reqs)
    if traced:
        host_reqs = slice_reqs[: max(1, len(slice_reqs) // 4)]
        run.host_slice = trace.profile(lambda: work(host_reqs), len(host_reqs), device, True)
    run.memory_peak_bytes = _peak(device)
    run.inputs = (grid, vae0, gp0)
    run.produced = {"core": server.core(), "requests": kept, "replies": replies}
    del server
    _free()
    t_ref = time.perf_counter()
    run.ref = reference(run)
    run.reference_s = time.perf_counter() - t_ref
    run.numbers = {**checks.serving_numbers(run.produced, run.ref), "failed_requests": run.failed}


def _peak(device) -> int | None:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else None


KINDS = {"train": train, "serve": serve}
