"""Build the package's CUDA sources into shared libraries with a plain C
interface, at first use, and load them with ctypes.

A library is one or more sources (``LIBRARY_SOURCES``; by default
``csrc/<name>.cu`` alone). ``nvcc -gencode arch=compute_90a,code=sm_90a
-O3 -c`` compiles each source into an object under
``build/merlot_tpu_torch/`` beside the package, and ``nvcc -shared`` links
a library's objects into ``lib<name>-<hash>.so`` there (the hashes are of
the sources and the shared headers, so an edited source is rebuilt). A
source that several libraries share (K1's tiled launch and its fp32
route, which K2's stats pass and K3's prefill also run) compiles once.
``build_libraries`` starts one nvcc per missing object, all at once, so
the longest source sets the build's time; ``build_seconds`` keeps each
compile's and link's wall seconds. Nothing here runs at import time.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the sources of each library made of more than its own csrc/<name>.cu
_FWD_TILES = ("attention_fwd_tiles", "attention_fwd_f32")
LIBRARY_SOURCES = {
    "attention_fwd": ("attention_fwd",) + _FWD_TILES,
    "attention_bwd": ("attention_bwd", "attention_bwd_f32") + _FWD_TILES,
    "attention_stacked": ("attention_stacked",) + _FWD_TILES,
}
# libraries a library links beyond the CUDA runtime
LINK_FLAGS = {"jpeg": ["-lnvjpeg"]}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each build, by library name
build_logs: dict[str, str] = {}
# wall seconds of each compile ("<source>.cu") and link ("lib<name>")
build_seconds: dict[str, float] = {}


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


def sources(name: str) -> tuple:
    """The csrc sources (without .cu) that make library ``name``."""
    return LIBRARY_SOURCES.get(name, (name,))


def _digest(srcs) -> str:
    h = hashlib.sha256()
    for src in srcs:
        h.update((CSRC_DIR / f"{src}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def _obj_path(src: str) -> Path:
    return BUILD_DIR / f"{src}-{_digest([src])}.o"


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(sources(name))}.so"


def _run_all(jobs: list) -> list:
    """Start every (key, argv, target) job at once; each writes a temporary
    file that replaces ``target`` when nvcc succeeds. Returns (key, log,
    failed) per job, with its wall seconds in ``build_seconds``."""
    import time
    started = []
    try:
        for key, argv, target in jobs:
            fd, tmp = tempfile.mkstemp(suffix=target.suffix, dir=BUILD_DIR)
            os.close(fd)
            started.append((key, tmp, target, time.perf_counter(), subprocess.Popen(
                [*argv, "-o", tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs: dict = {}

        def wait(key, t0, proc):  # each job's own wall time, as it ends
            logs[key] = proc.communicate()[0]
            build_seconds[key] = time.perf_counter() - t0

        waiters = [threading.Thread(target=wait, args=(key, t0, proc))
                   for key, _, _, t0, proc in started]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
        out = []
        for key, tmp, target, _, proc in started:
            if proc.returncode == 0:
                os.replace(tmp, target)
            out.append((key, logs[key], proc.returncode != 0))
        return out
    finally:
        for _, tmp, _, _, proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


def build_libraries(names: Iterable[str]) -> None:
    """Compile every missing object of the named libraries, one nvcc
    process each, all started together, then link the missing libraries;
    raises if any step fails."""
    with _lock:
        todo = [n for n in dict.fromkeys(names) if not _lib_path(n).exists()]
        if not todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        srcs = [s for s in dict.fromkeys(s for n in todo for s in sources(n))
                if not _obj_path(s).exists()]
        compiled = _run_all([(f"{s}.cu", [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / f"{s}.cu")],
                              _obj_path(s)) for s in srcs])
        logs = {key[:-3]: log for key, log, _ in compiled}
        failed = [f"nvcc failed on {key}:\n{log}" for key, log, bad in compiled if bad]
        if failed:
            raise RuntimeError("\n".join(failed))
        linked = _run_all([(f"lib{n}", [nvcc, "-shared", *NVCC_FLAGS[:2],
                                        *map(str, map(_obj_path, sources(n))),
                                        *LINK_FLAGS.get(n, [])], _lib_path(n))
                           for n in todo])
        for n in todo:
            build_logs[n] = "".join(logs.get(s, "") for s in sources(n))
        failed = [f"linking {key}.so failed:\n{log}" for key, log, bad in linked if bad]
        if failed:
            raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it."""
    if name not in _loaded:
        build_libraries([name])
        with _lock:
            _loaded.setdefault(name, ctypes.CDLL(str(_lib_path(name))))
    return _loaded[name]
