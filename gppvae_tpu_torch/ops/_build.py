"""Build the port's CUDA kernels at first use and load them with ctypes.

`nvcc` compiles every `csrc/*.cu` of this package for `sm_90a`, one process
per source, all started together, and links the objects into one shared
library with a plain C interface. The library lands in
`gppvae_tpu_torch/_build/<hash of the sources, the headers they include
and the flags>/` (listed in
.gitignore), so an edit to a kernel rebuilds it and an unchanged tree reuses
it. nvcc's output (including `-Xptxas -v`'s registers and shared memory per
kernel) is kept beside it in `nvcc.log`.

A failed build raises with nvcc's stderr: there is no fallback.

`build(defines)` builds another copy with preprocessor defines (its own
directory, `<hash>-<defines>`): tools/torch_nll_core_steps.py and
tools/torch_factor_prep_steps.py build the kernels' step clocks
(`GPPVAE_STEP_CLOCK`) so; the package's own build never sets a define.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from gppvae_tpu_torch.utils.timers import span

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("factor_prep.cu", "nll_core.cu", "conv3x3.cu")
HEADERS = ("hopper.cuh",)  # included by the sources: part of the hash
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")
LIB_NAME = "libgppvae_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: (restype, argtypes); each launch is one call, its plan passed in
    "gppvae_factor_prep": (_I, [*[_P] * 7, *[_I] * 12, _P]),
    "gppvae_factor_prep_capacity": (_I, [_I, _I, _I]),
    "gppvae_nll_core_props": (_I, [_P]),
    "gppvae_nll_core_clusters": (_I, [_I, _I]),
    "gppvae_nll_core": (_I, [*[_P] * 8, *[_I] * 7, _P]),
    "gppvae_conv3x3_fprop": (_I, [*[_P] * 4, ctypes.POINTER(_I), _P]),
    "gppvae_conv3x3_backward": (_I, [*[_P] * 9, *[ctypes.POINTER(_I)] * 2, ctypes.c_longlong,
                                     _P]),
    "gppvae_conv3x3_ctas": (_I, [_I] * 5),
    "gppvae_error_string": (ctypes.c_char_p, [_I]),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME/bin (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "need the CUDA toolkit"
    )


def source_hash() -> str:
    h = hashlib.sha256(" ".join((*COMPILE_FLAGS, *LINK_FLAGS)).encode())
    for name in (*SOURCES, *HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def run_nvcc(cmd: list[str]) -> subprocess.CompletedProcess:
    """Run one nvcc command line, capturing its output."""
    return subprocess.run(cmd, capture_output=True, text=True, timeout=600)


def compile_library(nvcc: str, lib: Path, defines: tuple[str, ...] = ()) -> tuple[bool, str]:
    """Compile every source (one nvcc each, all started together) into
    objects beside `lib`, then link them into `lib`. Returns (ok, log)."""
    objs = [lib.parent / (Path(name).stem + ".o") for name in SOURCES]
    flags = (*COMPILE_FLAGS, *(f"-D{d}" for d in defines))
    cmds = [[nvcc, *flags, "-c", "-o", str(obj), str(CSRC / name)]
            for name, obj in zip(SOURCES, objs)]
    with ThreadPoolExecutor(len(cmds)) as pool:
        procs = list(pool.map(run_nvcc, cmds))
    if all(p.returncode == 0 for p in procs):
        procs.append(run_nvcc([nvcc, *LINK_FLAGS, "-o", str(lib), *map(str, objs)]))
    log = "".join(" ".join(p.args) + "\n" + p.stdout + p.stderr for p in procs)
    return all(p.returncode == 0 for p in procs), log


def build_dir(defines: tuple[str, ...] = ()) -> Path:
    return BUILD_ROOT / "-".join((source_hash(), *defines))


def build(defines: tuple[str, ...] = ()) -> Path:
    """Path of the built library, compiling it if this tree has not yet."""
    out_dir = build_dir(defines)
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # build in a temporary directory, then rename the library: a concurrent
    # or interrupted build never leaves a half-written one under the final name
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        ok, log = compile_library(nvcc, tmp / LIB_NAME, defines)
        (out_dir / "nvcc.log").write_text(log)
        if not ok:
            raise KernelBuildError("nvcc failed:\n" + log)
        os.replace(tmp / LIB_NAME, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.cache
def load(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once per process
    (per set of defines): the span `kernels.load`."""
    with span("kernels.load"):
        lib = ctypes.CDLL(str(build(defines)))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
    return lib


@functools.cache
def device_props(index: int) -> dict:
    """What the kernels' plans read of CUDA device `index`, once per device:
    `sms`, `smem_optin` (bytes of shared memory a block may opt into),
    `max_cluster` (the largest cluster of nll_core's cluster kernel at that
    shared memory) and `grid_per_sm` (resident CTAs of its grid kernel)."""
    import torch

    out = (ctypes.c_int * 4)()
    with torch.cuda.device(index):
        check(load().gppvae_nll_core_props(out), "device properties")
    return dict(zip(("sms", "smem_optin", "max_cluster", "grid_per_sm"), out))


def check(err: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if err != 0:
        msg = load().gppvae_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def nvcc_log() -> str:
    """nvcc's output for the current build ('' before the first build)."""
    log = build_dir() / "nvcc.log"
    return log.read_text() if log.is_file() else ""
