"""Copy of `mcos_tpu/utils/chain_loader.py`; both load the shared
`native/libchain_loader.so`, built on first use with `make -C native`.
tests/test_torch_copies.py holds the two equal.

Option-chain loading: native C++ fast path with a pure-Python fallback.

The calibration pipeline ingests option-chain CSVs
(expiry_years, strike, is_call, bid, ask, open_interest). The hot parser is
`native/chain_loader.cpp` (C ABI, ctypes-bound, built on first use with the
repo's Makefile); when no compiler is available the numpy fallback parses the
same format. Both apply the liquidity screen from the reference's
CalibrationConfig (min open interest, max bid-ask spread as a fraction of
mid — engine/config.py:122-124).

Returned chain dict: expiry, strike, is_call, bid, ask, mid, open_interest,
liquid (bool mask) — ready for `CalibrationEngine.calibrate` /
`extract_iv_surface`.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Dict, Optional

import numpy as np

from mcos_tpu_torch.config import CALIBRATION_CONFIG

logger = logging.getLogger("mcos_tpu_torch.chain_loader")

_NATIVE_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "native"))
_LIB_PATH = os.path.join(_NATIVE_DIR, "libchain_loader.so")

_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _build_native() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        logger.info("native chain loader build unavailable: %s", e)
        return False


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    if not os.path.exists(_LIB_PATH) and not _build_native():
        _lib_failed = True
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.chain_count_rows.argtypes = [ctypes.c_char_p]
        lib.chain_count_rows.restype = ctypes.c_long
        dptr = ctypes.POINTER(ctypes.c_double)
        lib.chain_parse.argtypes = [ctypes.c_char_p, ctypes.c_long] \
            + [dptr] * 7 + [ctypes.c_double, ctypes.c_double]
        lib.chain_parse.restype = ctypes.c_long
        _lib = lib
    except OSError as e:
        logger.warning("failed to load native chain loader: %s", e)
        _lib_failed = True
    return _lib


def _as_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _load_native(path: str, min_oi: float,
                 max_spread_pct: float) -> Optional[Dict[str, np.ndarray]]:
    lib = _get_lib()
    if lib is None:
        return None
    n = lib.chain_count_rows(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    cols = {name: np.empty(n, np.float64)
            for name in ("expiry", "strike", "is_call", "bid", "ask",
                         "open_interest", "liquid")}
    wrote = lib.chain_parse(
        path.encode(), n,
        _as_ptr(cols["expiry"]), _as_ptr(cols["strike"]),
        _as_ptr(cols["is_call"]), _as_ptr(cols["bid"]), _as_ptr(cols["ask"]),
        _as_ptr(cols["open_interest"]), _as_ptr(cols["liquid"]),
        float(min_oi), float(max_spread_pct))
    if wrote < 0:
        raise IOError(f"native parse failed for {path}")
    return {k: v[:wrote] for k, v in cols.items()}


def _load_python(path: str, min_oi: float,
                 max_spread_pct: float) -> Dict[str, np.ndarray]:
    rows = []
    with open(path) as f:
        next(f)  # header
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 6:
                continue
            try:
                flag = parts[2].strip().lower()
                is_call = 1.0 if flag[:1] in ("1", "t", "c") else 0.0
                rows.append((float(parts[0]), float(parts[1]), is_call,
                             float(parts[3]), float(parts[4]),
                             float(parts[5])))
            except (ValueError, IndexError):
                continue
    arr = np.asarray(rows, np.float64).reshape(-1, 6)
    mid = 0.5 * (arr[:, 3] + arr[:, 4])
    liquid = ((arr[:, 5] >= min_oi) & (mid > 0)
              & ((arr[:, 4] - arr[:, 3]) <= max_spread_pct * mid))
    return {
        "expiry": arr[:, 0], "strike": arr[:, 1], "is_call": arr[:, 2],
        "bid": arr[:, 3], "ask": arr[:, 4], "open_interest": arr[:, 5],
        "liquid": liquid.astype(np.float64),
    }


def load_chain(path: str,
               min_oi: Optional[float] = None,
               max_spread_pct: Optional[float] = None,
               force_python: bool = False) -> Dict[str, np.ndarray]:
    """Load an option-chain CSV with liquidity screening.

    Uses the native parser when available (built lazily from native/),
    otherwise the numpy fallback — identical output either way (tested).
    """
    min_oi = (CALIBRATION_CONFIG.min_open_interest
              if min_oi is None else min_oi)
    max_spread_pct = (CALIBRATION_CONFIG.max_bid_ask_spread_pct
                      if max_spread_pct is None else max_spread_pct)
    chain = None
    if not force_python:
        chain = _load_native(path, min_oi, max_spread_pct)
    if chain is None:
        chain = _load_python(path, min_oi, max_spread_pct)
    chain["mid"] = 0.5 * (chain["bid"] + chain["ask"])
    chain["liquid"] = chain["liquid"].astype(bool)
    return chain


def chain_to_calibration_inputs(chain: Dict[str, np.ndarray],
                                expiry: float,
                                side: str = "call") -> Dict[str, np.ndarray]:
    """One liquid expiry slice → (strikes, market_prices, spreads) arrays for
    `CalibrationEngine.calibrate`. side: "call" | "put"."""
    if side not in ("call", "put"):
        raise ValueError(f"side must be 'call' or 'put', got {side!r}")
    sel = chain["liquid"] & np.isclose(chain["expiry"], expiry)
    sel &= (chain["is_call"] > 0.5) if side == "call" \
        else (chain["is_call"] < 0.5)
    order = np.argsort(chain["strike"][sel])
    return {
        "strikes": chain["strike"][sel][order].astype(np.float32),
        "market_prices": chain["mid"][sel][order].astype(np.float32),
        "bid_ask_spreads": (chain["ask"][sel] - chain["bid"][sel])[order]
        .astype(np.float32),
    }
