"""The data path's native code, built at first use, never at import.

``load()`` compiles ``native.cc`` (a copy of the JAX package's, plus a
libjpeg encoder) with g++ into ``build/merlot_tpu_torch/`` beside the
package and imports it. It holds crc32c, the tfrecord framing scan, the
Example scan, the fused align-corners resize and, when ``jpeglib.h`` is
present at build time, libjpeg's decode and encode. ``-ffp-contract=off``
keeps the resize bit-exact with the numpy version (no FMA contraction). If
the build fails, ``load()`` returns None and callers use their Python
versions.

JPEG decodes and encodes by one route (``jpeg_route``), by default the
first of these that the machine has:
  * ``libjpeg``: the extension above, as in the JAX package;
  * ``pil``: without libjpeg's header, PIL (imported when first used),
    the decoder the JAX package falls back to: the same libjpeg
    underneath, so the same pixels;
  * ``nvjpeg``: nvJPEG from the CUDA toolkit (``csrc/jpeg.cu``, built by
    ``_build`` with ``-lnvjpeg``), which decodes and encodes on the card.
    Its IDCT and chroma upsampling are not libjpeg's, so its pixels may
    differ from libjpeg's by a few levels. It is the default only where
    neither libjpeg nor PIL is there; ``set_jpeg_route("nvjpeg")`` asks
    for it by name.
A JPEG that the route's decoder refuses (a CMYK one, for instance) decodes
with PIL, as JAX's ``decode_jpeg_u8`` does; one that PIL cannot read either
raises. With no route at all, decoding raises an error that names what is
missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parents[2] / "build" / "merlot_tpu_torch"
JPEG_HEADERS = ("/usr/include/jpeglib.h", "/usr/include/x86_64-linux-gnu/jpeglib.h",
                "/usr/local/include/jpeglib.h")
MODULE = "merlot_tpu_torch.data._native._merlot_native"

_lock = threading.Lock()
_state: dict = {}


def have_libjpeg() -> bool:
    return any(os.path.exists(p) for p in JPEG_HEADERS)


def _command(out: str) -> list:
    include = sysconfig.get_paths()["include"]
    cmd = ["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17",
           f"-I{include}", str(HERE / "native.cc"), "-o", out]
    if have_libjpeg():
        cmd += ["-DMERLOT_HAVE_JPEG", "-ljpeg"]
    return cmd


def _lib_path() -> Path:
    h = hashlib.sha256((HERE / "native.cc").read_bytes())
    h.update(" ".join(_command("")).encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"_merlot_native-{h.hexdigest()[:16]}{suffix}"


def load():
    """The compiled extension (built on the first call), or None when it
    cannot be built here (``build_error()`` says why)."""
    if "module" in _state:
        return _state["module"]
    with _lock:
        if "module" not in _state:
            _state["module"] = None
            try:
                path = _lib_path()
                if not path.exists():
                    BUILD_DIR.mkdir(parents=True, exist_ok=True)
                    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                    os.close(fd)
                    try:
                        subprocess.run(_command(tmp), check=True, capture_output=True,
                                       text=True)
                        os.replace(tmp, path)
                    finally:
                        if os.path.exists(tmp):
                            os.unlink(tmp)
                spec = importlib.util.spec_from_file_location(MODULE, path)
                module = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(module)
                _state["module"] = module
            except (OSError, ImportError, subprocess.CalledProcessError) as e:
                detail = getattr(e, "stderr", "") or ""
                _state["error"] = f"{e} {detail}".strip()
        return _state["module"]


def build_error() -> Optional[str]:
    load()
    return _state.get("error")


# ----------------------------------------------------------------------
# JPEG
# ----------------------------------------------------------------------
def _nvjpeg_header() -> Optional[Path]:
    from merlot_tpu_torch import _build
    try:
        nvcc = Path(_build.find_nvcc())
    except RuntimeError:
        return None
    header = nvcc.resolve().parents[1] / "include" / "nvjpeg.h"
    return header if header.exists() else None


def _nvjpeg_lib():
    """csrc/jpeg.cu's library with its C signatures declared."""
    from merlot_tpu_torch import _build
    with _lock:
        if "nvjpeg" in _state:
            return _state["nvjpeg"]
    lib = _build.load_library("jpeg")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.merlot_jpeg_info.argtypes = [u8p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int)]
    lib.merlot_jpeg_decode.argtypes = [u8p, ctypes.c_size_t, u8p, ctypes.c_int,
                                       ctypes.c_int]
    lib.merlot_jpeg_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       u8p, ctypes.c_size_t,
                                       ctypes.POINTER(ctypes.c_size_t)]
    for f in (lib.merlot_jpeg_info, lib.merlot_jpeg_decode, lib.merlot_jpeg_encode):
        f.restype = ctypes.c_int
    lib.merlot_jpeg_error.argtypes = []
    lib.merlot_jpeg_error.restype = ctypes.c_char_p
    with _lock:
        _state["nvjpeg"] = lib
    return lib


JPEG_ROUTES = ("libjpeg", "pil", "nvjpeg")


def _have_pil() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def _default_route() -> str:
    module = load()
    if module is not None and hasattr(module, "decode_jpeg"):
        return "libjpeg"
    if _have_pil():
        return "pil"
    if _nvjpeg_header() is not None:
        _nvjpeg_lib()
        return "nvjpeg"
    raise RuntimeError(
        "no JPEG route on this machine: libjpeg's header (one of "
        f"{', '.join(JPEG_HEADERS)}) is missing, PIL does not import, and nvJPEG "
        "(nvjpeg.h of the CUDA toolkit beside nvcc) is missing too"
        + (f"; the native extension failed to build: {build_error()}"
           if module is None else ""))


def jpeg_route() -> str:
    """The route JPEGs take in this process: the one ``set_jpeg_route``
    named, else this machine's default ('libjpeg', else 'pil', else
    'nvjpeg'; see the module docstring). Raises when there is none."""
    with _lock:
        route = _state.get("chosen") or _state.get("route")
    if route is not None:
        return route
    route = _default_route()
    with _lock:
        _state["route"] = route
    return route


def set_jpeg_route(route: Optional[str]) -> None:
    """Decode and encode JPEGs by ``route`` (one of ``JPEG_ROUTES``) from
    now on in this process, or by the machine's default (None). Raises if
    this machine does not have it."""
    if route is not None and route not in JPEG_ROUTES:
        raise ValueError(f"unknown JPEG route {route!r}; routes: {JPEG_ROUTES}")
    if route == "libjpeg" and not hasattr(load(), "decode_jpeg"):
        raise RuntimeError(f"no libjpeg route here: {build_error() or 'no jpeglib.h'}")
    if route == "pil" and not _have_pil():
        raise RuntimeError("no pil route here: PIL does not import")
    if route == "nvjpeg":
        _nvjpeg_lib()
    with _lock:
        _state["chosen"] = route


def _pil_decode(data: bytes) -> np.ndarray:
    import io

    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), dtype=np.uint8)


def _nvjpeg_decode(data: bytes) -> np.ndarray:
    lib = _nvjpeg_lib()
    src = np.frombuffer(data, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.merlot_jpeg_info(_u8(src), src.size, ctypes.byref(h), ctypes.byref(w)):
        raise ValueError(f"jpeg decode failed: {lib.merlot_jpeg_error().decode()}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.merlot_jpeg_decode(_u8(src), src.size, _u8(out), h.value, w.value):
        raise ValueError(f"jpeg decode failed: {lib.merlot_jpeg_error().decode()}")
    return out


def _u8(array: np.ndarray):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 RGB [H, W, 3] by ``jpeg_route()``; what its
    decoder refuses decodes with PIL."""
    route = jpeg_route()
    if route == "pil":
        return _pil_decode(data)
    try:
        if route == "libjpeg":
            h, w, rgb = load().decode_jpeg(data)
            return np.frombuffer(rgb, np.uint8).reshape(h, w, 3)
        return _nvjpeg_decode(data)
    except ValueError as refused:
        # an odd colourspace (CMYK, ...): PIL, as the JAX package does
        if not _have_pil():
            raise refused
        return _pil_decode(data)


def encode_jpeg(rgb: np.ndarray, quality: int = 80) -> bytes:
    """uint8 RGB [H, W, 3] -> JPEG bytes (4:2:0, baseline) by
    ``jpeg_route()``."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes [H, W, 3] uint8, got {rgb.shape}")
    h, w = rgb.shape[:2]
    route = jpeg_route()
    if route == "libjpeg":
        return load().encode_jpeg(rgb.tobytes(), h, w, quality)
    if route == "pil":
        import io

        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="JPEG", quality=quality)
        return buf.getvalue()
    lib = _nvjpeg_lib()
    cap = h * w * 3 + 65536
    out = np.empty(cap, np.uint8)
    n = ctypes.c_size_t()
    if lib.merlot_jpeg_encode(_u8(rgb), h, w, quality, _u8(out), cap, ctypes.byref(n)):
        raise ValueError(f"jpeg encode failed: {lib.merlot_jpeg_error().decode()}")
    return out[:n.value].tobytes()
