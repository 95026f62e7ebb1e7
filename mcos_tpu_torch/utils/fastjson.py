"""Copy of `mcos_tpu/utils/fastjson.py`; both load the shared
`native/libfastjson.so`. tests/test_torch_copies.py holds the two equal.

Serving-path JSON encoding: native float-array serializer + raw-chunk
splicing.

`/api/price` ships ~4k floats per response; CPython json.dumps plus the
per-element rounding loop costs ~6 ms of GIL-held host CPU per request —
the single-core throughput ceiling under concurrent load (the device work is
parallel, the serializer is not). `native/fastjson.cpp` (C ABI, ctypes,
built lazily with the repo Makefile like the chain loader) formats a float
array at fixed decimals in <0.3 ms; the pure-numpy fallback keeps hermetic
environments working with identical parsed values.

Usage:
    chunk = float_array_json(paths_2d, decimals=2)   # JsonChunk
    body = {"sample_paths": chunk, ...}
    data = dumps(body)                               # splices chunk raw

`dumps` is a drop-in for json.dumps for objects that may contain JsonChunk
values (anywhere json.dumps would call default=...).
"""

from __future__ import annotations

import ctypes
import json
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger("mcos_tpu_torch.fastjson")

_NATIVE_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "native"))
_LIB_PATH = os.path.join(_NATIVE_DIR, "libfastjson.so")

_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
_lib_lock = threading.Lock()


def _build_native() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        logger.info("native fastjson build unavailable: %s", e)
        return False


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        if not os.path.exists(_LIB_PATH) and not _build_native():
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            dptr = ctypes.POINTER(ctypes.c_double)
            lib.json_float_array.argtypes = [
                dptr, ctypes.c_long, ctypes.c_int, ctypes.c_char_p,
                ctypes.c_long]
            lib.json_float_array.restype = ctypes.c_long
            lib.json_float_matrix.argtypes = [
                dptr, ctypes.c_long, ctypes.c_long, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_long]
            lib.json_float_matrix.restype = ctypes.c_long
            _lib = lib
        except OSError as e:  # pragma: no cover - load failure
            logger.info("native fastjson load failed: %s", e)
            _lib_failed = True
    return _lib


class JsonChunk:
    """A pre-serialized JSON fragment, spliced verbatim by `dumps`."""

    __slots__ = ("raw",)

    def __init__(self, raw: str):
        self.raw = raw


def _fallback_json(arr: np.ndarray, decimals: int) -> str:
    # Non-finite → null, matching the native encoder (stdlib json.dumps
    # would emit bare NaN/Infinity — invalid JSON that browsers reject).
    # Rounding is half-AWAY-from-zero on the scaled value, matching the
    # native llround — np.round's half-to-even would flip exact halves
    # (0.125 @ 2 → 0.12 vs native 0.13) between environments.
    scale = 10.0 ** decimals
    scaled = arr * scale
    with np.errstate(invalid="ignore"):
        rounded = np.where(scaled >= 0, np.floor(scaled + 0.5),
                           np.ceil(scaled - 0.5)) / scale
    out = rounded.astype(object)
    out[~np.isfinite(arr)] = None
    return json.dumps(out.tolist())


def float_array_json(arr, decimals: int = 2) -> JsonChunk:
    """Encode a 1-D or 2-D float array as a JSON array chunk at fixed
    decimals (non-finite → null). Native when available, numpy fallback
    otherwise — parsed values are identical either way."""
    a = np.ascontiguousarray(np.asarray(arr, np.float64))
    if a.ndim not in (1, 2):
        raise ValueError(f"need 1-D or 2-D array, got {a.ndim}-D")
    lib = _get_lib()
    if lib is None:
        return JsonChunk(_fallback_json(a, decimals))
    # Worst case ~34 bytes per element + brackets/commas.
    cap = 40 * a.size + 16 * (a.shape[0] if a.ndim == 2 else 1) + 64
    buf = ctypes.create_string_buffer(cap)
    ptr = a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    if a.ndim == 1:
        n = lib.json_float_array(ptr, a.size, decimals, buf, cap)
    else:
        n = lib.json_float_matrix(ptr, a.shape[0], a.shape[1], decimals,
                                  buf, cap)
    if n < 0:  # pragma: no cover - capacity bound is generous
        return JsonChunk(_fallback_json(a, decimals))
    return JsonChunk(buf.raw[:n].decode("ascii"))


def to_list(x):
    """Unwrap a JsonChunk back to Python data (identity for plain values).
    For in-process consumers of handler outputs (tests, examples) — over
    HTTP the chunk is already spliced into the response JSON."""
    return json.loads(x.raw) if isinstance(x, JsonChunk) else x


_PLACEHOLDER = "@mcos-json-chunk-{}@"


def dumps(obj) -> str:
    """json.dumps with JsonChunk values spliced in raw.

    Chunks are temporarily encoded as unique placeholder strings, then the
    quoted placeholders are replaced by the raw fragments. Placeholders are
    plain ASCII (no escaping ambiguity) and carry a per-call list index, so
    nested/multiple chunks are safe.
    """
    chunks: list = []

    def default(o):
        if isinstance(o, JsonChunk):
            chunks.append(o.raw)
            return _PLACEHOLDER.format(len(chunks) - 1)
        raise TypeError(
            f"Object of type {type(o).__name__} is not JSON serializable")

    s = json.dumps(obj, default=default)
    for i, raw in enumerate(chunks):
        s = s.replace('"' + _PLACEHOLDER.format(i) + '"', raw, 1)
    return s
