"""Start `world` ranks and run a function on each.

The JAX package is single-controller (one process over a mesh, no launcher);
this is the port's counterpart of `make_mesh`: `world` processes started with
the `spawn` method (CUDA cannot be forked), each joined to one process group
through a torch.distributed FileStore in a fresh temporary directory (no TCP
port, so any number of groups can start side by side), each holding a
`DataGroup`, or with `mesh=(data, model)` a `MeshGroup` of the 2-D mesh
(the counterpart of `make_mesh_2d`; mesh.py).

    from gppvae_tpu_torch.parallel import run_ranks
    results = run_ranks(fn, 2, backend="gloo", device="cpu", args=(a, b))
    results = run_ranks(fn, 4, backend="gloo", device="cpu", mesh=(2, 2))

`fn(group, *args)` runs on every rank and its return values come back as a
list by rank; `fn` and `args` are pickled, so `fn` is a module-level function
and the args plain data. Each rank imports the caller's main module again
(spawn), so a script starts ranks under `if __name__ == "__main__":`.
`RankPool` keeps the ranks (and their process group) for several calls.
`backend` is the caller's ("gloo" or "nccl"); nothing is tried in its place.
`device` "cpu", "cuda:K" (every rank on card K: gloo) or "cuda" (rank r on
card r mod the card count: one rank per card for nccl). A rank's exception,
or its exit, fails the call with that rank's traceback, and the pool is
closed: its other ranks may be waiting in a collective.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import tempfile
import traceback

import torch

# how long a rank waits in one collective before it fails (and so the call);
# a call itself may run for as long as its work takes
TIMEOUT_S = 900.0


def rank_device(device: str, rank: int) -> torch.device:
    """The rank's device for a `device` spec (see the module docstring);
    raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _mesh_group(rank: int, mesh: tuple[int, int], dev: torch.device):
    """The rank's MeshGroup. torch.distributed.new_group is collective over
    the world: every rank creates every axis group, in one fixed order
    (each model row, then each data column), and keeps its own two."""
    import torch.distributed as dist

    from gppvae_tpu_torch.parallel.mesh import MeshGroup

    data, model = mesh
    i, j = divmod(rank, model)  # row-major, as make_mesh_2d's reshape
    rows = [dist.new_group([r * model + c for c in range(model)]) for r in range(data)]
    cols = [dist.new_group([r * model + c for r in range(data)]) for c in range(model)]
    return MeshGroup(rank=i, world=data, device=dev, model_rank=j, model_size=model,
                     data_pg=cols[j], model_pg=rows[i])


def _rank_main(rank: int, world: int, backend: str, device: str, store_path: str,
               mesh, conn) -> None:
    """A rank's process: join the group and say so, then run (fn, args)
    messages until None; each answer is ("ok", result) or ("err",
    traceback)."""
    import torch.distributed as dist

    from gppvae_tpu_torch.parallel.mesh import DataGroup

    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        group = (DataGroup(rank=rank, world=world, device=dev) if mesh is None
                 else _mesh_group(rank, mesh, dev))
    except Exception:  # reported to the launcher, which fails with it
        conn.send(("err", traceback.format_exc()))
        return
    conn.send(("ok", None))
    try:
        while (msg := conn.recv()) is not None:
            fn, args = msg
            try:
                out = ("ok", fn(group, *args))
            except Exception:  # reported to the launcher, which fails with it
                out = ("err", traceback.format_exc())
            conn.send(out)
    finally:
        dist.destroy_process_group()


class RankPool:
    """`world` rank processes that run one call after another (`run`, or
    `submit` then `result`); close them with `close` or a `with` block.
    `mesh` (data, model) with data × model = world makes them a 2-D mesh."""

    def __init__(self, world: int, *, backend: str, device: str,
                 mesh: tuple[int, int] | None = None):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        if mesh is not None:
            mesh = tuple(int(a) for a in mesh)
            if len(mesh) != 2 or min(mesh) < 1 or mesh[0] * mesh[1] != world:
                raise ValueError(f"mesh {mesh} is not (data, model) of {world} ranks")
        self.world, self.mesh = world, mesh
        ctx = multiprocessing.get_context("spawn")
        self._tmp = tempfile.TemporaryDirectory(prefix="gppvae_ranks_")
        store = os.path.join(self._tmp.name, "store")
        self._conns, self._procs = [], []
        self._pending = False
        for rank in range(world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_rank_main, daemon=True,
                               args=(rank, world, backend, device, store, mesh, child))
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)
        self._pending = True
        self.result()  # every rank joined the group, or the rank's error

    def submit(self, fn, *args) -> None:
        """Start fn(group, *args) on every rank; `result` collects it."""
        if self._pending:
            raise RuntimeError("the pool runs one call at a time: collect the last one first")
        if self.closed:
            raise RuntimeError("the pool is closed")
        for conn in self._conns:
            conn.send((fn, args))
        self._pending = True

    def result(self) -> list:
        """The submitted call's return values, by rank."""
        out: dict[int, object] = {}
        by_conn = {c: r for r, c in enumerate(self._conns)}
        try:
            while len(out) < self.world:
                waiting = [c for c, r in by_conn.items() if r not in out]
                for conn in multiprocessing.connection.wait(waiting):
                    rank = by_conn[conn]
                    try:
                        status, value = conn.recv()
                    except EOFError:
                        raise RuntimeError(f"rank {rank} of {self.world} exited (code "
                                           f"{self._procs[rank].exitcode}) before answering")
                    if status == "err":
                        raise RuntimeError(f"rank {rank} of {self.world} failed:\n{value}")
                    out[rank] = value
        except BaseException:
            self.close()
            raise
        self._pending = False
        return [out[r] for r in range(self.world)]

    @property
    def closed(self) -> bool:
        return not self._procs

    def run(self, fn, *args) -> list:
        """fn(group, *args) on every rank; its return values by rank."""
        self.submit(fn, *args)
        return self.result()

    def close(self) -> None:
        """Stop the ranks (those still waiting in a collective are killed)."""
        for conn, proc in zip(self._conns, self._procs):
            if not self._pending and proc.is_alive():
                try:
                    conn.send(None)
                except OSError:
                    pass
        for proc in self._procs:
            proc.join(timeout=30 if not self._pending else 0.1)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        self._tmp.cleanup()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run_ranks(fn, world: int, *, backend: str, device: str, args: tuple = (),
              mesh: tuple[int, int] | None = None) -> list:
    """fn(group, *args) on `world` fresh ranks; its return values by rank."""
    with RankPool(world, backend=backend, device=device, mesh=mesh) as pool:
        return pool.run(fn, *args)
