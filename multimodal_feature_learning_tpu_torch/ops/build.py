"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` exposes a plain ``extern "C"`` launcher, so it
compiles in seconds without PyTorch's headers. Libraries go to
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the source and the flags, so an unchanged source is built
once; beside each library, ``<name>.ptxas.txt`` keeps what ``-Xptxas -v``
said of its kernels (registers, shared memory, spills). Nothing is built
when a module is imported: a wrapper asks for its library on its first
launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNEL_SOURCES = ("msda_fwd.cu", "msda_bwd.cu", "fused_decode.cu", "probe_add.cu",
                  "hungarian.cu")


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH)")


def library_path(source: str, flags: Tuple[str, ...] = ()) -> Path:
    src = (CSRC_DIR / source).read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS + tuple(flags)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(sources: Iterable[str] = KERNEL_SOURCES,
          variants: Iterable[Tuple[str, Tuple[str, ...]]] = ()) -> Dict[str, float]:
    """Compile every source, and every (source, extra nvcc flags) variant,
    that has no library yet: one ``nvcc`` each, all started together.
    Returns {name: seconds} of the builds it ran; raises with the
    compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for source, flags in [(s, ()) for s in sources] + list(variants):
        lib = library_path(source, flags)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(CSRC_DIR / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running.append((" ".join((source,) + tuple(flags)), lib, tmp, proc, time.monotonic()))
    seconds, failed = {}, []
    for source, lib, tmp, proc, t0 in running:
        output, _ = proc.communicate()
        seconds[source] = time.monotonic() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source}:\n{output}")
        else:
            os.replace(tmp, lib)
            lib.with_suffix(".ptxas.txt").write_text(output)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def ptxas_report(source: str, flags: Tuple[str, ...] = ()) -> list:
    """The ``-Xptxas -v`` lines of a built library: for each kernel, its
    registers, shared memory and spill stores and loads."""
    log = library_path(source, flags).with_suffix(".ptxas.txt")
    if not log.exists():
        return []
    keep = ("Compiling entry", "Function properties", "registers", "spill")
    return [line.split("info    : ")[-1].strip() for line in log.read_text().splitlines()
            if any(k in line for k in keep)]


def load_library(source: str, flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The compiled library of ``source`` (with the extra nvcc ``flags``),
    built first if needed."""
    build([], [(source, tuple(flags))])
    return ctypes.CDLL(str(library_path(source, flags)))


class KernelBinding:
    """A ctypes binding of one ``extern "C"`` launcher of ``csrc/``, loaded
    (and built) at its first launch. ``launches`` counts the kernel launches
    it made; nothing else changes it but a caller resetting it."""

    source = symbol = ""
    argtypes: list = []
    flags: tuple = ()  # extra nvcc flags of the library

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _launcher(self):
        if self._fn is None:
            fn = getattr(load_library(self.source, self.flags), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn
