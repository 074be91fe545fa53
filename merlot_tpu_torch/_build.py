"""Build the package's CUDA sources into shared libraries with a plain C
interface, at first use, and load them with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` compiles
``csrc/<name>.cu`` into ``build/merlot_tpu_torch/lib<name>-<hash>.so``
beside the package (the hash is of the source and the shared headers, so
an edited source is rebuilt). ``build_libraries`` starts one nvcc per
missing library, all at once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterable

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "merlot_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# libraries a source links beyond the CUDA runtime
LINK_FLAGS = {"jpeg": ["-lnvjpeg"]}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each build, by source name
build_logs: dict[str, str] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_libraries(names: Iterable[str]) -> None:
    """Compile every named source whose library is missing, one nvcc
    process each, all started together; raises if any build fails."""
    with _lock:
        todo = [n for n in dict.fromkeys(names) if not _lib_path(n).exists()]
        if not todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        jobs = []
        try:
            for name in todo:
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                jobs.append((name, tmp, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu"),
                     *LINK_FLAGS.get(name, [])],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            failed = []
            for name, tmp, proc in jobs:
                log, _ = proc.communicate()
                build_logs[name] = log
                if proc.returncode != 0:
                    failed.append(f"nvcc failed on {name}.cu:\n{log}")
                else:
                    os.replace(tmp, _lib_path(name))
            if failed:
                raise RuntimeError("\n".join(failed))
        finally:
            for _, tmp, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.unlink(tmp)


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it."""
    if name not in _loaded:
        build_libraries([name])
        with _lock:
            _loaded.setdefault(name, ctypes.CDLL(str(_lib_path(name))))
    return _loaded[name]
