"""Builds the CUDA sources under ``csrc/`` into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers, so it
compiles in seconds) and becomes
``super_resolution_tpu_torch/_build/lib<name>_<hash>.so``, where the hash
covers the source text and the compiler flags: an edited source is rebuilt,
an unchanged one is loaded as it is. Libraries are loaded with ``ctypes``.

Nothing here runs when the module is imported. A missing compiler or a
failed compile raises ``RuntimeError`` with the compiler's output; there is
no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_dir", "find_nvcc", "build", "load"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
# -split-compile=0 spreads the device-code optimisation of one source over
# all cores: degrade.cu's 96 BTV kernel instantiations build in about half
# the time.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-split-compile=0",
)

_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "_build"


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc was not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built."
    )


def _library_path(name: str) -> tuple[Path, Path]:
    source = CSRC_DIR / f"{name}.cu"
    if not source.is_file():
        raise RuntimeError(f"No CUDA source {source}.")
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return source, build_dir() / f"lib{name}_{digest}.so"


def build(names=None) -> dict[str, dict]:
    """Compile the named sources (default: every ``csrc/*.cu``) that are not built yet.

    All compilers are started together, one ``nvcc`` per source, and then
    waited for. Returns ``{name: {"path", "seconds", "built", "log"}}``; the
    log is the compiler's output (register and shared-memory use per kernel).
    """
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    results, running = {}, []
    nvcc = None
    for name in names:
        source, lib = _library_path(name)
        log_path = lib.with_suffix(".log")
        if lib.is_file():
            log = log_path.read_text() if log_path.is_file() else ""
            results[name] = {"path": str(lib), "seconds": 0.0, "built": False, "log": log}
            continue
        nvcc = nvcc or find_nvcc()
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((name, lib, tmp, log_path, proc, time.perf_counter()))
    for name, lib, tmp, log_path, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}")
        os.replace(tmp, lib)  # atomic: a concurrent build sees a whole file or none
        log_path.write_text(log)
        results[name] = {"path": str(lib), "seconds": seconds, "built": True, "log": log}
    return results


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if need be."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(build([name])[name]["path"])
    return lib
