"""Build the port's CUDA kernels at first use and load them with ctypes.

`nvcc` compiles every `csrc/*.cu` of this package for `sm_90a` into one
shared library with a plain C interface. The library lands in
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
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("factor_prep.cu", "nll_core.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libgppvae_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: (restype, argtypes)
    "gppvae_factor_prep_workspace": (ctypes.c_size_t, [_I, _I, _I]),
    "gppvae_factor_prep": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "gppvae_nll_core_scratch": (ctypes.c_size_t, [_I]),
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Path of the built library, compiling it if this tree has not yet."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # compile to a temporary name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        (out_dir / "nvcc.log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        )
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
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
