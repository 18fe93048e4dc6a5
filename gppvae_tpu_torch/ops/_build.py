"""Build the port's CUDA kernels at first use and load them with ctypes.

`nvcc` compiles every `csrc/*.cu` of this package for `sm_90a`, one process
per source, all started together, and links the objects into one shared
library with a plain C interface. The library lands in
`gppvae_tpu_torch/_build/<hash of the sources and flags>/` (listed in
.gitignore), so an edit to a kernel rebuilds it and an unchanged tree reuses
it. nvcc's output (including `-Xptxas -v`'s registers and shared memory per
kernel) is kept beside it in `nvcc.log`.

A failed build raises with nvcc's stderr: there is no fallback.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("factor_prep.cu", "nll_core.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")
LIB_NAME = "libgppvae_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: (restype, argtypes)
    "gppvae_factor_prep_workspace": (ctypes.c_size_t, [_I, _I, _I]),
    "gppvae_factor_prep_tickets": (ctypes.c_size_t, [_I, _I, _I]),
    "gppvae_factor_prep": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "gppvae_nll_core_scratch": (ctypes.c_size_t, [_I, _I]),
    "gppvae_nll_core": (
        _I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    ),
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
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def run_nvcc(cmd: list[str]) -> subprocess.CompletedProcess:
    """Run one nvcc command line, capturing its output."""
    return subprocess.run(cmd, capture_output=True, text=True, timeout=600)


def compile_library(nvcc: str, lib: Path) -> tuple[bool, str]:
    """Compile every source (one nvcc each, all started together) into
    objects beside `lib`, then link them into `lib`. Returns (ok, log)."""
    objs = [lib.parent / (Path(name).stem + ".o") for name in SOURCES]
    cmds = [[nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(CSRC / name)]
            for name, obj in zip(SOURCES, objs)]
    with ThreadPoolExecutor(len(cmds)) as pool:
        procs = list(pool.map(run_nvcc, cmds))
    if all(p.returncode == 0 for p in procs):
        procs.append(run_nvcc([nvcc, *LINK_FLAGS, "-o", str(lib), *map(str, objs)]))
    log = "".join(" ".join(p.args) + "\n" + p.stdout + p.stderr for p in procs)
    return all(p.returncode == 0 for p in procs), log


def build() -> Path:
    """Path of the built library, compiling it if this tree has not yet."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # build in a temporary directory, then rename the library: a concurrent
    # or interrupted build never leaves a half-written one under the final name
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        ok, log = compile_library(nvcc, tmp / LIB_NAME)
        (out_dir / "nvcc.log").write_text(log)
        if not ok:
            raise KernelBuildError("nvcc failed:\n" + log)
        os.replace(tmp / LIB_NAME, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if err != 0:
        msg = load().gppvae_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def nvcc_log() -> str:
    """nvcc's output for the current build ('' before the first build)."""
    log = BUILD_ROOT / source_hash() / "nvcc.log"
    return log.read_text() if log.is_file() else ""
