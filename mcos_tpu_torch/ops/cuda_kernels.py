"""Hand-written CUDA kernels of the port, their wrappers, their plain torch
versions and their build (counterpart of `mcos_tpu/ops/pallas_kernels.py`
for the kernels on the `/api/price`, `/api/convergence`, `/api/exotic`,
`/api/hhw`, `/api/svcj`, `/api/termsvj` and `/api/rough` paths).

K1 `svj_terminal_from_draws` (csrc/svj_draws.cu) replaces
    `svj_terminal_from_draws_pallas` / `_svj_draws_kernel`, and
    `svj_terminal_from_draws_population` the JAX package's vmap of it over
    a calibration population: one launch for P parameter sets on one draw
    set (the single-member wrapper is its P = 1 call; both count on
    `svj_terminal_from_draws.launches`).
K2 `gbm_terminal` (csrc/gbm.cu) replaces
    `gbm_terminal_pallas` / `_gbm_kernel`.
K3 `svj_terminal` (csrc/svj.cu) replaces
    `svj_terminal_pallas` / `_svj_kernel`.
K4 `svj_terminal_qe` (csrc/svj_qe.cu) replaces
    `svj_terminal_qe_pallas` / `_svj_qe_kernel`.
K5 `svj_terminal_qe_from_draws` (csrc/svj_qe_draws.cu) replaces
    `svj_terminal_qe_from_draws_pallas` / `_svj_qe_draws_kernel`.
K6 `svj_path_stats` (csrc/svj_stats.cu) replaces
    `svj_path_stats_pallas` / `_svj_stats_kernel`.
K7 `hhw_terminal` (csrc/hhw.cu) replaces
    `hhw_terminal_pallas` / `_hhw_kernel`.
K8 `svcj_terminal` (csrc/svcj.cu) replaces
    `svcj_terminal_pallas` / `_svcj_kernel`.
K9 `svj_terminal_td` (csrc/svj_td.cu) replaces
    `svj_terminal_td_pallas` / `_svj_td_kernel`.
K10 `rbergomi_lift_integrals` (csrc/rbergomi_lift.cu) replaces
    `rbergomi_lift_integrals_pallas` / `_rbergomi_lift_kernel`.
K11 `rbergomi_lift_stats` (csrc/rbergomi_stats.cu) replaces
    `rbergomi_lift_stats_pallas` / `_rbergomi_lift_stats_kernel`.
`svj_viz` (csrc/svj_viz.cu) replaces no Pallas kernel: it runs the whole
    step loop of `/api/price`'s viz-path recorder or histogram sampler
    (`ops/simulate.py:simulate_paths_recorded`, `simulate_terminal_samples`),
    the JAX package's `lax.scan` programs, in one launch on their draws.

The wrapper rule: a CPU input takes the plain torch version; a CUDA input
launches the kernel or raises. There is no fallback from one to the other.
Each wrapper counts its launches in a plain int attribute, `.launches`,
which it increments where it launches the kernel and nowhere else.

Build: `nvcc -gencode arch=compute_90a,code=sm_90a` compiles every source
in `csrc/` (one nvcc process per source, all started together) and links
them into one shared library with a plain C interface, loaded with ctypes.
It runs at first use, under a process-wide lock, into
`mcos_tpu_torch/_build/` (listed in .gitignore), and rebuilds when the
sources' hash changes. `build_seconds()` reports how long it took.

The plain Philox4x32-10 below is the kernels' generator on int64 tensors
with 32-bit masks (torch has no usable uint32 arithmetic); it gives the
same words as csrc/philox.cuh, so a kernel's in-kernel random mode can be
compared word for word with its plain version. Each kernel's stream has
its own counter domain (word 3): K1/K5 jumps 0, K2 1, K3 2, K4 3, K6 4,
K7 5, K8 6, K9 7, K10 8, K11 9.

The plain versions repeat each kernel's float32 operations in the same
order. Where a result feeds a discontinuous select (the QE transition's
branches; K6's dead-or-alive test on the log-spot carry), and in K1, K3,
K4 and K6-K11, the CUDA source keeps nvcc from contracting multiply-adds
and the plain version here performs the same IEEE operations, so the two
agree bit for bit; elsewhere (K5's log spot) they differ by FMA
rounding. K2 also takes the
hardware's approximate log2, rsqrt and sincos where its plain version
calls torch's accurate functions (csrc/gbm.cu says how far apart they
are).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mcos_tpu_torch.models.params import SVCJParams, SVJParams
from mcos_tpu_torch.ops.exotics import (
    corridor_surv_increment,
    single_surv_increment,
)
from mcos_tpu_torch.ops.hhw import HHWParams, hhw_cholesky
from mcos_tpu_torch.ops.simulate import (
    qe_variance_step,
    recorded_from_draws,
    simulate_terminal,
)
from mcos_tpu_torch.ops.sobol import ndtri_acklam
from mcos_tpu_torch.utils import spans

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_M32 = 0xFFFFFFFF


# ─────────────────────────────────────────────────────────────────────────────
# Build and load
# ─────────────────────────────────────────────────────────────────────────────
class _Library:
    """The compiled kernels: built once per process, under a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.build_seconds: Optional[float] = None
        self.path: Optional[str] = None

    @staticmethod
    def _sources():
        names = sorted(f for f in os.listdir(CSRC_DIR)
                       if f.endswith((".cu", ".cuh")))
        return [os.path.join(CSRC_DIR, f) for f in names]

    @staticmethod
    def _nvcc() -> str:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        for cand in (os.path.join(cuda_home, "bin", "nvcc"),
                     shutil.which("nvcc")):
            if cand and os.path.exists(cand):
                return cand
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from mcos_tpu_torch/csrc at first use")

    def _compile(self, cu_sources, lib_path: str) -> None:
        """One nvcc per source, all running at once, then one link."""
        nvcc = self._nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as obj_dir:
            jobs = []
            for src in cu_sources:
                obj = os.path.join(
                    obj_dir, os.path.basename(src)[:-len(".cu")] + ".o")
                jobs.append((obj, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
            failures = []
            for obj, proc in jobs:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    failures.append(f"nvcc failed ({proc.returncode}) on "
                                    f"{os.path.basename(obj)}:\n{err}")
            if failures:
                raise RuntimeError("\n".join(failures))
            tmp = os.path.join(obj_dir, "lib.so")
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
                 *[obj for obj, _ in jobs]], capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({link.returncode}):\n{link.stderr}")
            os.replace(tmp, lib_path)

    def get(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                self._lib = self._build_and_load()
        return self._lib

    def _build_and_load(self) -> ctypes.CDLL:
        t0 = time.perf_counter()
        sources = self._sources()
        digest = hashlib.sha256()
        for path in sources:
            with open(path, "rb") as f:
                digest.update(os.path.basename(path).encode() + f.read())
        digest.update(" ".join(NVCC_FLAGS).encode())
        os.makedirs(BUILD_DIR, exist_ok=True)
        lib_path = os.path.join(
            BUILD_DIR, f"libmcos_kernels_{digest.hexdigest()[:16]}.so")
        if not os.path.exists(lib_path):
            self._compile([s for s in sources if s.endswith(".cu")],
                          lib_path)
            spans.count("kernel_library_builds")
        lib = ctypes.CDLL(lib_path)
        spans.count("kernel_library_loads")
        vp, i32, i64, u64, f32 = (ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_ulonglong,
                                  ctypes.c_float)
        lib.mcos_svj_terminal_from_draws_population.argtypes = [
            vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, u64, vp]
        lib.mcos_svj_terminal_from_draws_population.restype = i32
        lib.mcos_gbm_terminal.argtypes = [
            vp, i64, i32, i32, u64, f32, f32, f32, vp]
        lib.mcos_gbm_terminal.restype = i32
        for name in ("mcos_svj_terminal", "mcos_svj_terminal_qe"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, vp, i32, i64, i32, i32, u64, vp, vp]
            fn.restype = i32
        lib.mcos_svj_terminal_qe_from_draws.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, i64, i32, i32, u64, vp, vp]
        lib.mcos_svj_terminal_qe_from_draws.restype = i32
        lib.mcos_svj_path_stats.argtypes = [
            vp, i64, i32, i32, i32, i32, i32, i32, u64, vp, vp]
        lib.mcos_svj_path_stats.restype = i32
        lib.mcos_hhw_terminal.argtypes = [vp, vp, i64, i32, i32, u64, vp, vp]
        lib.mcos_hhw_terminal.restype = i32
        lib.mcos_svcj_terminal.argtypes = [
            vp, vp, vp, i64, i32, i32, u64, vp, vp]
        lib.mcos_svcj_terminal.restype = i32
        lib.mcos_svj_terminal_td.argtypes = [
            vp, vp, vp, vp, vp, i32, i64, i32, i32, u64, vp, vp]
        lib.mcos_svj_terminal_td.restype = i32
        lib.mcos_rbergomi_lift_integrals.argtypes = [
            vp, vp, vp, i64, i32, i32, u64, vp, vp, i32, vp]
        lib.mcos_rbergomi_lift_integrals.restype = i32
        lib.mcos_rbergomi_lift_stats.argtypes = [
            vp, vp, i64, i32, i32, u64, vp, vp, i32, vp]
        lib.mcos_rbergomi_lift_stats.restype = i32
        lib.mcos_svj_viz.argtypes = [vp, vp, vp, vp, i64, i32, i32, vp]
        lib.mcos_svj_viz.restype = i32
        lib.mcos_cuda_error_string.argtypes = [i32]
        lib.mcos_cuda_error_string.restype = ctypes.c_char_p
        self.path = lib_path
        self.build_seconds = time.perf_counter() - t0
        return lib


_LIBRARY = _Library()
# Launch counts are bumped from the HTTP server's threads.
_COUNT_LOCK = threading.Lock()


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load the kernels' shared library."""
    return _LIBRARY.get()


def build_seconds() -> Optional[float]:
    """Seconds the first `load_library()` took (build + load), or None."""
    return _LIBRARY.build_seconds


def _check_rc(lib: ctypes.CDLL, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.mcos_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _seed_words(seed: int) -> Tuple[int, int]:
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return seed & _M32, (seed >> 32) & _M32


# ─────────────────────────────────────────────────────────────────────────────
# Plain Philox4x32-10 (the generator of csrc/philox.cuh) on int64 tensors
# ─────────────────────────────────────────────────────────────────────────────
_PHILOX_10A, _PHILOX_10B = 0x9E3779B9, 0xBB67AE85
_PHILOX_SA, _PHILOX_SB = 0xD2511F53, 0xCD9E8D57
# Counter domains of csrc/philox.cuh (word 3 of the counter).
(_JUMP_DOMAIN, _GBM_DOMAIN, _SVJ_DOMAIN, _QE_DOMAIN, _STATS_DOMAIN,
 _HHW_DOMAIN, _SVCJ_DOMAIN, _TD_DOMAIN, _ROUGH_DOMAIN,
 _ROUGH_STATS_DOMAIN) = range(10)


def _mulhilo32(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) 32-bit words of a·b for a constant a < 2³² and 0 ≤ b < 2³²,
    through 16-bit halves of b so no int64 product overflows."""
    p0 = (b & 0xFFFF) * a                      # < 2⁴⁸
    p1 = (b >> 16) * a                         # < 2⁴⁸
    mid = p0 + ((p1 & 0xFFFF) << 16)           # < 2⁴⁹
    return mid & _M32, (p1 >> 16) + (mid >> 32)


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Four int64 tensors of 32-bit words: Philox4x32-10 of the counter
    (c0, c1, c2, c3) (int64 tensors or ints, broadcast) under key (k0, k1)."""
    like = next(c for c in (c0, c1, c2, c3) if isinstance(c, torch.Tensor))
    c = [c if isinstance(c, torch.Tensor) else torch.full_like(like, c)
         for c in (c0, c1, c2, c3)]
    for rnd in range(10):
        lo0, hi0 = _mulhilo32(_PHILOX_SA, c[0])
        lo1, hi1 = _mulhilo32(_PHILOX_SB, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        if rnd < 9:
            k0 = (k0 + _PHILOX_10A) & _M32
            k1 = (k1 + _PHILOX_10B) & _M32
    return c


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """((bits >> 9) + 0.5) · 2⁻²³ in float32: strictly inside (0, 1), exact."""
    return ((bits >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)


def philox_jump_uniforms(num_steps: int, num_paths: int, seed: int,
                         device) -> torch.Tensor:
    """(num_steps, num_paths) jump uniforms of K1's in-kernel mode: counter
    (path_lo, path_hi, step // 4, 0), key = seed, word step % 4."""
    k0, k1 = _seed_words(seed)
    path = torch.arange(num_paths, dtype=torch.int64, device=device)
    rows = []
    for quad in range(-(-num_steps // 4)):
        words = philox4x32_10(path & _M32, path >> 32, quad, _JUMP_DOMAIN,
                              k0, k1)
        rows.extend(bits_to_uniform(w) for w in words)
    return torch.stack(rows[:num_steps])


def _pair_words(num_paths: int, call: int, domain: int, seed: int, device):
    """Philox words of counter (pair_lo, pair_hi, call, domain) for pairs
    0..num_paths-1, as four float32 uniform tensors."""
    k0, k1 = _seed_words(seed)
    pair = torch.arange(num_paths, dtype=torch.int64, device=device)
    return [bits_to_uniform(w)
            for w in philox4x32_10(pair & _M32, pair >> 32, call, domain,
                                   k0, k1)]


# ─────────────────────────────────────────────────────────────────────────────
# Device helpers of csrc/philox.cuh in plain torch
# ─────────────────────────────────────────────────────────────────────────────
_TWO_PI_F32 = float(np.float32(2.0 * math.pi))


def box_muller(u1: torch.Tensor, u2: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r·cos(2πu₂), r·sin(2πu₂) with r = √(−2 log u₁), on the float32
    angle 2π·u₂ (philox.cuh:box_muller)."""
    rad = torch.sqrt(-2.0 * torch.log(u1))
    ang = u2 * _TWO_PI_F32
    return rad * torch.cos(ang), rad * torch.sin(ang)


# The count table's length: the upper tail beyond it is below 2⁻²⁴, under
# the uniforms' grid ((k + ½)·2⁻²³ never exceeds 1 − 2⁻²⁴), and it has at
# least the reference table's 64 entries.
_COUNT_TAIL = 2.0 ** -24
_COUNT_MIN_LEN = 64


def binom_count_table(lam_dt: float, num_steps: int) -> np.ndarray:
    """CDF of the path's jump count, Binomial(num_steps, λ·dt), in float64:
    entry k is P(count ≤ k), for k up to the first whose upper tail is
    below 2⁻²⁴ (and at least 64 entries; entries past num_steps are 1).

    The counterpart of `_binom_count_cdf` without its two faults: that
    float32 table stops at 64 entries and divides by its last one, which
    conditions the count on < 64 and turns into NaN once (1−p)ⁿ
    underflows. Here the pmf is built in log space, so it never
    underflows to a NaN, and the table is as long as the tail needs.
    """
    n = int(num_steps)
    p = min(max(float(lam_dt), 0.0), 1.0)
    if n < 0:
        raise ValueError(f"num_steps must be non-negative, got {n}")
    if p == 0.0:
        return np.ones(_COUNT_MIN_LEN)
    k = np.arange(n + 1, dtype=np.float64)
    if p == 1.0:
        pmf = (k == n).astype(np.float64)
    else:
        # log pmf_k = n·log(1−p) + k·log(p/(1−p)) + Σ_{j<k} log((n−j)/(j+1))
        steps = np.log((n - k[:-1]) / (k[:-1] + 1.0))
        log_pmf = (n * math.log1p(-p) + k * (math.log(p) - math.log1p(-p))
                   + np.concatenate([[0.0], np.cumsum(steps)]))
        pmf = np.exp(log_pmf)
    upper = np.cumsum(pmf[::-1])[::-1] - pmf      # P(count > k)
    length = int(np.argmax(upper < _COUNT_TAIL)) + 1   # upper[n] = 0
    cdf = np.minimum(np.cumsum(pmf)[:length], 1.0)
    if cdf.size < _COUNT_MIN_LEN:
        cdf = np.concatenate([cdf, np.ones(_COUNT_MIN_LEN - cdf.size)])
    return cdf


def count_from_table(u: torch.Tensor, cdf: np.ndarray) -> torch.Tensor:
    """Jump counts Σₖ 1{u > cdf_k} as float32 (philox.cuh:count_from_table)."""
    table = torch.as_tensor(cdf, dtype=torch.float64, device=u.device)
    return (u.double()[:, None] > table[None, :]).sum(dim=1).to(torch.float32)


@functools.lru_cache(maxsize=64)
def _device_table(lam_dt: float, num_steps: int, device: str) -> torch.Tensor:
    """The count table on `device`, built and copied once per shape."""
    return torch.as_tensor(binom_count_table(lam_dt, num_steps),
                           dtype=torch.float64, device=device)


def poisson_binom_count_table(p_steps) -> np.ndarray:
    """CDF of a path's jump count under per-step jump probabilities
    `p_steps` (the Poisson-binomial law of Σᵢ Bernoulli(pᵢ), pᵢ = λᵢ·dt
    clipped to [0, 1]), in float64: entry k is P(count ≤ k), for k up to
    the first whose upper tail is below 2⁻²⁴ (and at least 64 entries;
    entries past the step count are 1).

    The counterpart of `_poisson_binom_cdf` without its fault: that
    64-entry float32 table divides by its last entry, which conditions the
    count on < 64 (Σpᵢ reaches 200 over HTTP). The pmf is built by the same
    recursion, pmf ← (1 − pᵢ)·pmf + pᵢ·shift(pmf), on a window of the first
    L counts (exact for those counts, whatever lies beyond), and L doubles
    until the tail beyond the window is below 2⁻²⁴.
    """
    p = np.clip(np.asarray(p_steps, np.float64).reshape(-1), 0.0, 1.0)
    n = p.size
    mean = float(p.sum())
    window = int(min(n + 1, max(_COUNT_MIN_LEN,
                                math.ceil(mean + 8.0 * math.sqrt(mean) + 32))))
    while True:
        pmf = np.zeros(window)
        pmf[0] = 1.0
        for p_i in p:
            pmf[1:] = (1.0 - p_i) * pmf[1:] + p_i * pmf[:-1]
            pmf[0] *= 1.0 - p_i
        cdf = np.minimum(np.cumsum(pmf), 1.0)
        upper = 1.0 - cdf
        if window == n + 1:
            upper[-1] = 0.0
        below = upper < _COUNT_TAIL
        if below.any():
            break
        window = min(n + 1, 2 * window)
    cdf = cdf[:int(np.argmax(below)) + 1]
    if cdf.size < _COUNT_MIN_LEN:
        cdf = np.concatenate([cdf, np.ones(_COUNT_MIN_LEN - cdf.size)])
    return cdf


@functools.lru_cache(maxsize=64)
def _device_td_table(p_bytes: bytes, device: str) -> torch.Tensor:
    """The Poisson-binomial count table on `device`, built and copied once
    per (λᵢ·dt) array."""
    return torch.as_tensor(
        poisson_binom_count_table(np.frombuffer(p_bytes, np.float64)),
        dtype=torch.float64, device=device)


@functools.lru_cache(maxsize=64)
def _device_step_table(tab_bytes: bytes, num_steps: int,
                       device: str) -> torch.Tensor:
    """A (rows, steps) float32 step table (K9's four rows, K10/K11's two)
    on `device`, copied once per table: a warm request then launches
    without a synchronous host-to-device copy in front of the kernel. The
    bytes are copied into a writable array first, so torch does not warn
    about wrapping a read-only buffer."""
    tab = np.frombuffer(bytearray(tab_bytes), np.float32)
    return torch.as_tensor(tab.reshape(-1, num_steps), device=device)


# ─────────────────────────────────────────────────────────────────────────────
# K1: SVJ terminal state from streamed draws
# ─────────────────────────────────────────────────────────────────────────────
def _svj_consts(params: SVJParams, spot, T, num_steps: int) -> np.ndarray:
    """The 15 per-launch float32 scalars of csrc/svj_draws.cu:SvjConsts, in
    the arithmetic of mcos_tpu/ops/pallas_kernels.py:_pack_params."""
    return _svj_consts_table([params], spot, T, num_steps)[0]


# SVJParams fields in the order of the table columns that copy them.
_SVJ_FIELDS = ("v0", "kappa", "theta", "xi", "rho", "mu_j", "sigma_j",
               "lambda_j", "r", "q")
_SVJ_COPIED = [1, 4, 5, 6, 7, 10, 11]


def _svj_consts_table(consts_or_params, spot, T,
                      num_steps: int) -> np.ndarray:
    """The (P, 15) float32 table of a population: `_svj_consts`'s
    arithmetic a column at a time, in one numpy pass over a sequence of
    SVJParams; or such a table itself (which carries its own spot, T and
    step count)."""
    if isinstance(consts_or_params, np.ndarray):
        table = np.ascontiguousarray(consts_or_params, np.float32)
        if table.ndim != 2 or table.shape[1] != 15:
            raise ValueError(f"a consts table is (P, 15), got "
                             f"{consts_or_params.shape}")
        if table.shape[0] == 0:
            raise ValueError("the population has no member")
        return table
    if len(consts_or_params) == 0:
        raise ValueError("the population has no member")
    f = np.float32
    fields = np.array([[getattr(p, name) for name in _SVJ_FIELDS]
                       for p in consts_or_params], np.float32)
    (v0, kappa, theta, xi, rho, mu_j, sig_j), (lam, r, q) = (
        fields[:, :7].T, fields[:, 7:].T)
    table = np.empty((len(fields), 15), np.float32)
    table[:, _SVJ_COPIED] = fields[:, :7]
    with np.errstate(all="ignore"):
        dt = f(T) / f(num_steps)
        k = np.exp(mu_j + f(0.5) * sig_j ** 2) - f(1.0)
        sigma_cv = np.sqrt(v0)
        table[:, 0] = f(spot)
        table[:, 2] = dt
        table[:, 3] = np.sqrt(dt)
        table[:, 8] = np.sqrt(f(1.0) - rho ** 2)
        table[:, 9] = lam * dt
        table[:, 12] = (r - q - lam * k) * dt
        table[:, 13] = (r - q - f(0.5) * sigma_cv ** 2) * dt
        table[:, 14] = sigma_cv
    return table


def _steps_major(x: torch.Tensor, steps_major: bool) -> torch.Tensor:
    return x if steps_major else x.T


def svj_terminal_from_draws_population_plain(
    consts_or_params, spot, T, z1, z2, u_jump, z_js, *, seed: int = 0,
    antithetic: bool = True, companion: bool = False,
    steps_major: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain torch version of K1: every member's scalars, the kernel's
    algebra (csrc/svj_draws.cu: sums of sqrt(v) z1 and of v carried for
    the log spot, the drift, the jumps and the companion leg summed apart,
    the mean reversion and xi dW2 on products taken once a member) in its
    order of IEEE operations, and its output layout, one step at a time
    with a leading member axis. u_jump=None
    draws the uniforms from `philox_jump_uniforms` (the kernel's in-kernel
    stream). Returns (S, v, G or None), each (P, n_branch, num_paths)."""
    z1, z2, z_js = (_steps_major(x, steps_major) for x in (z1, z2, z_js))
    num_steps, num_paths = z1.shape
    device = z1.device
    if u_jump is None:
        u_jump = philox_jump_uniforms(num_steps, num_paths, seed, device)
    else:
        u_jump = _steps_major(u_jump, steps_major)
    table = _svj_consts_table(consts_or_params, spot, T, num_steps)
    # Each scalar a (P, 1, 1) column, exact float32 as the kernel reads it.
    (spot_f, v0, dt, sqrt_dt, kappa, theta, xi, rho, rho_perp, lam_dt, mu_j,
     sig_j, drift_dt, g_drift_dt, sig_cv) = torch.from_numpy(
        table.T.copy()).to(device)[:, :, None, None]
    kdt = kappa * dt
    one_minus_kdt = 1.0 - kdt
    kdt_theta = kdt * theta
    xi_rho = (xi * rho) * sqrt_dt
    xi_rho_perp = (xi * rho_perp) * sqrt_dt
    n_branch = 2 if antithetic else 1
    sign = torch.tensor([1.0, -1.0][:n_branch], dtype=torch.float32,
                        device=device)[:, None]
    members = table.shape[0]
    sz = torch.zeros((members, n_branch, num_paths), dtype=torch.float32,
                     device=device)
    sv = torch.zeros_like(sz)
    v = torch.clamp(v0, min=0.0).expand(sz.shape).clone()
    hits = torch.zeros((members, 1, num_paths), dtype=torch.float32,
                       device=device)
    zj_sum = torch.zeros_like(hits)
    z1_sum = torch.zeros(num_paths, dtype=torch.float32, device=device)
    for t in range(num_steps):
        z1_sum = z1_sum + z1[t]
        a, b = z1[t] * sign, z2[t] * sign
        xi_dw2 = xi_rho * a + xi_rho_perp * b
        hit = u_jump[t] < lam_dt
        hits = torch.where(hit, hits + 1.0, hits)
        zj_sum = torch.where(hit, zj_sum + z_js[t], zj_sum)
        sqrt_v = torch.sqrt(v)
        sz = sz + sqrt_v * a
        sv = sv + v
        v = torch.clamp(v * one_minus_kdt + kdt_theta + sqrt_v * xi_dw2,
                        min=0.0)
    x = sqrt_dt * sz - (0.5 * dt) * sv
    steps_f = float(num_steps)
    jump = mu_j * hits + sign * (sig_j * zj_sum)
    s = spot_f * torch.exp(drift_dt * steps_f + x + jump)
    g = None
    if companion:
        log_g = g_drift_dt * steps_f + sign * ((z1_sum * sqrt_dt) * sig_cv)
        g = spot_f * torch.exp(log_g)
    return s, v, g


def svj_terminal_from_draws_plain(
    params: SVJParams, spot, T, z1, z2, u_jump, z_js, *, seed: int = 0,
    antithetic: bool = True, companion: bool = False,
    steps_major: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain torch version of K1 at one member: the population's plain
    version on a one-row table, each output (n_branch, num_paths)."""
    s, v, g = svj_terminal_from_draws_population_plain(
        [params], spot, T, z1, z2, u_jump, z_js, seed=seed,
        antithetic=antithetic, companion=companion, steps_major=steps_major)
    return s[0], v[0], (g[0] if companion else None)


def _check_draw(name: str, x: torch.Tensor, ref: torch.Tensor) -> None:
    if x.device != ref.device:
        raise ValueError(f"{name} is on {x.device}, z1 on {ref.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.shape != ref.shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"z1 {tuple(ref.shape)}")


def svj_terminal_from_draws_population(
    consts_or_params, spot, T, z1: torch.Tensor, z2: torch.Tensor,
    u_jump: Optional[torch.Tensor], z_js: torch.Tensor, *, seed: int = 0,
    antithetic: bool = True, companion: bool = False,
    steps_major: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """K1 wrapper: P parameter sets on one draw set in one launch, the
    counterpart of the JAX package's vmap of `svj_terminal_from_draws_pallas`
    over a population.

    Args:
        consts_or_params: a sequence of P SVJParams, or their (P, 15)
            `_svj_consts` table.
        z1, z2, z_js, u_jump: float32 draws, (num_steps, num_paths) with
            `steps_major=True` (what `sobol_svj_draws` gives) or
            (num_paths, num_steps). u_jump=None draws the jump uniforms
            in-kernel from Philox keyed on `seed`.
    Returns:
        (S, v, G or None), each (P, n_branch, num_paths): member p's rows
        are what a one-member launch on its parameters gives; branch 0 the
        base, branch 1 (antithetic) the negated normals with shared jump
        uniforms. The one launch counts once, on
        `svj_terminal_from_draws.launches` (K1's count).
    """
    draws = {"z1": z1, "z2": z2, "z_js": z_js}
    if u_jump is not None:
        draws["u_jump"] = u_jump
    for name, x in draws.items():
        _check_draw(name, x, z1)
    if z1.dim() != 2 or z1.numel() == 0:
        raise ValueError(f"draws must be non-empty 2-D, got {tuple(z1.shape)}")
    if z1.device.type == "cpu":
        return svj_terminal_from_draws_population_plain(
            consts_or_params, spot, T, z1, z2, u_jump, z_js, seed=seed,
            antithetic=antithetic, companion=companion,
            steps_major=steps_major)
    if z1.device.type != "cuda":
        raise ValueError(f"no kernel for device {z1.device}")

    # The kernel reads steps-major rows; paths-major input is transposed
    # into a copy (the serving path never takes this branch).
    draws = {k: _steps_major(x, steps_major).contiguous()
             for k, x in draws.items()}
    num_steps, num_paths = draws["z1"].shape
    n_branch = 2 if antithetic else 1
    _seed_words(seed)
    table = _svj_consts_table(consts_or_params, spot, T, num_steps)
    members = table.shape[0]
    # One host-to-device copy of the table a launch, queued on the stream
    # without waiting for it (the bytes are staged before the call returns).
    consts = torch.from_numpy(table).to(z1.device, non_blocking=True)
    out = torch.empty((3 if companion else 2, members, n_branch, num_paths),
                      dtype=torch.float32, device=z1.device)
    lib = load_library()
    with torch.cuda.device(z1.device):
        rc = lib.mcos_svj_terminal_from_draws_population(
            draws["z1"].data_ptr(), draws["z2"].data_ptr(),
            draws["z_js"].data_ptr(),
            draws["u_jump"].data_ptr() if u_jump is not None else None,
            consts.data_ptr(), out.data_ptr(), num_paths, num_steps,
            n_branch, members, int(companion), int(seed),
            _stream_handle(z1.device))
    _check_rc(lib, rc, "svj_terminal_from_draws_population")
    with _COUNT_LOCK:
        svj_terminal_from_draws.launches += 1
    return out[0], out[1], (out[2] if companion else None)


def svj_terminal_from_draws(
    params: SVJParams, spot, T, z1: torch.Tensor, z2: torch.Tensor,
    u_jump: Optional[torch.Tensor], z_js: torch.Tensor, *, seed: int = 0,
    antithetic: bool = True, companion: bool = False,
    steps_major: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """K1 wrapper at one member, the counterpart of
    `svj_terminal_from_draws_pallas`: `svj_terminal_from_draws_population`
    on `[params]` (the same arguments), each output (n_branch,
    num_paths)."""
    s, v, g = svj_terminal_from_draws_population(
        [params], spot, T, z1, z2, u_jump, z_js, seed=seed,
        antithetic=antithetic, companion=companion, steps_major=steps_major)
    return s[0], v[0], (g[0] if companion else None)


svj_terminal_from_draws.launches = 0


# ─────────────────────────────────────────────────────────────────────────────
# K2: GBM terminal spots from an in-kernel generator
# ─────────────────────────────────────────────────────────────────────────────
def _gbm_consts(spot, sigma, r, q, T, num_steps: int):
    """(spot, drift_dt, σ√dt) in float32, as gbm_terminal_pallas packs them."""
    f = np.float32
    dt = f(T) / f(num_steps)
    drift_dt = (f(r) - f(q) - f(0.5) * f(sigma) ** 2) * dt
    return f(spot), drift_dt, f(sigma) * np.sqrt(dt)


def gbm_terminal_plain(spot, sigma, r, q, T, seed: int, *, num_paths: int,
                       num_steps: int, antithetic: bool = True,
                       device="cpu") -> torch.Tensor:
    """Plain torch version of K2 on the kernel's Philox words (counter
    (path_lo, path_hi, step // 4, 1), key = seed); (n_branch, num_paths)."""
    device = torch.device(device)
    spot_f, drift_dt, sig_sqrt_dt = (
        float(x) for x in _gbm_consts(spot, sigma, r, q, T, num_steps))
    k0, k1 = _seed_words(seed)
    path = torch.arange(num_paths, dtype=torch.int64, device=device)
    ls0 = torch.zeros(num_paths, dtype=torch.float32, device=device)
    ls1 = torch.zeros_like(ls0)
    for quad in range(-(-num_steps // 4)):
        w = philox4x32_10(path & _M32, path >> 32, quad, _GBM_DOMAIN, k0,
                          k1)
        u = [bits_to_uniform(x) for x in w]
        z = []
        for u1, u2 in ((u[0], u[1]), (u[2], u[3])):
            rad = torch.sqrt(-2.0 * torch.log(u1))
            ang = u2.double() * (2.0 * math.pi)
            z += [rad * torch.cos(ang).float(), rad * torch.sin(ang).float()]
        for zk in z[:num_steps - 4 * quad]:
            st = sig_sqrt_dt * zk
            ls0 = ls0 + drift_dt + st
            ls1 = ls1 + drift_dt - st
    rows = [ls0, ls1] if antithetic else [ls0]
    return spot_f * torch.exp(torch.stack(rows))


def gbm_terminal(spot, sigma, r, q, T, seed: int, *, num_paths: int,
                 num_steps: int, antithetic: bool = True,
                 device="cuda") -> torch.Tensor:
    """K2 wrapper, the counterpart of `gbm_terminal_pallas`: terminal spots
    of a GBM, (n_branch, num_paths). A CPU `device` takes the plain version;
    a CUDA one launches the kernel or raises."""
    device = torch.device(device)
    if num_paths < 1 or num_steps < 1:
        raise ValueError("need num_paths >= 1 and num_steps >= 1")
    if device.type == "cpu":
        return gbm_terminal_plain(spot, sigma, r, q, T, seed,
                                  num_paths=num_paths, num_steps=num_steps,
                                  antithetic=antithetic, device=device)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    _seed_words(seed)
    spot_f, drift_dt, sig_sqrt_dt = _gbm_consts(spot, sigma, r, q, T,
                                                num_steps)
    n_branch = 2 if antithetic else 1
    out = torch.empty((n_branch, num_paths), dtype=torch.float32,
                      device=device)
    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.mcos_gbm_terminal(
            out.data_ptr(), num_paths, num_steps, n_branch, int(seed),
            float(spot_f), float(drift_dt), float(sig_sqrt_dt),
            _stream_handle(device))
    _check_rc(lib, rc, "gbm_terminal")
    with _COUNT_LOCK:
        gbm_terminal.launches += 1
    return out


gbm_terminal.launches = 0


# ─────────────────────────────────────────────────────────────────────────────
# Shared pieces of K3, K4 and K5
# ─────────────────────────────────────────────────────────────────────────────
def _svj_prng_consts(params: SVJParams, spot, T, num_steps: int
                     ) -> np.ndarray:
    """The 18 float32 scalars of csrc/svj.cu:SvjPrngConsts: `_svj_consts`
    plus the TPU kernel's hoisted forms −dt/2, 1 − κ·dt and κ·θ·dt."""
    f = np.float32
    base = _svj_consts(params, spot, T, num_steps)
    dt, kappa, theta = base[2], base[4], base[5]
    with np.errstate(all="ignore"):
        extra = (f(-0.5) * dt, f(1.0) - kappa * dt, kappa * theta * dt)
    return np.concatenate([base, np.asarray(extra, np.float32)])


_QE_FIELDS = ("spot", "v0", "theta", "e_kdt", "var1", "var2", "k0", "k1",
              "k2", "k34", "drift_dt", "lam_dt", "mu_j", "sig_j",
              "g_drift_dt", "sig_cv", "sqrt_dt")


def _qe_consts(params: SVJParams, spot, T, num_steps: int) -> np.ndarray:
    """The 17 float32 scalars of csrc/philox.cuh:QeConsts, in the order and
    arithmetic of mcos_tpu/ops/pallas_kernels.py:_pack_qe_params."""
    f = np.float32
    p = params
    with np.errstate(all="ignore"):
        dt = f(T) / f(num_steps)
        kappa, theta, xi, rho = f(p.kappa), f(p.theta), f(p.xi), f(p.rho)
        e_kdt = np.exp(-kappa * dt)
        c_mean = f(1.0) - e_kdt
        gamma = f(0.5)
        xi_safe = np.maximum(xi, f(1e-12))
        k_over = kappa * rho / xi_safe - f(0.5)
        k_comp = np.exp(f(p.mu_j) + f(0.5) * f(p.sigma_j) ** 2) - f(1.0)
        sigma_cv = np.sqrt(f(p.v0))
        vals = (
            f(spot), f(p.v0), theta, e_kdt,
            xi ** 2 * e_kdt * c_mean / np.maximum(kappa, f(1e-12)),
            theta * xi ** 2 * c_mean ** 2
            / np.maximum(f(2.0) * kappa, f(1e-12)),
            -rho * kappa * theta * dt / xi_safe,
            gamma * dt * k_over - rho / xi_safe,
            gamma * dt * k_over + rho / xi_safe,
            gamma * dt * (f(1.0) - rho ** 2),
            (f(p.r) - f(p.q) - f(p.lambda_j) * k_comp) * dt,
            f(p.lambda_j) * dt, f(p.mu_j), f(p.sigma_j),
            (f(p.r) - f(p.q) - f(0.5) * sigma_cv ** 2) * dt,
            sigma_cv, np.sqrt(dt),
        )
    return np.asarray(vals, np.float32)


def _qe_dict(consts: np.ndarray) -> dict:
    c = dict(zip(_QE_FIELDS, (float(x) for x in consts)))
    # drift_dt + k0 in float32, as the kernel adds them.
    c["drift_k0"] = float(np.float32(consts[10]) + np.float32(consts[6]))
    return c


def _qe_log_spot(c: dict, v, v_next, ls, lg, z_x, jump=None):
    """The central K-scheme log-spot and companion updates of one step for
    each branch (z_x negated on the second), K4/K5 order of operations."""
    vol = torch.sqrt(torch.clamp(c["k34"] * (v + v_next), min=0.0))
    base = c["drift_k0"] + c["k1"] * v + c["k2"] * v_next
    for k in range(len(ls)):
        sz_x = z_x if k == 0 else -z_x
        ls[k] = ls[k] + base + vol * sz_x
        if jump is not None:
            ls[k] = ls[k] + jump[k]
        lg[k] = lg[k] + c["g_drift_dt"] + c["sig_cv"] * sz_x * c["sqrt_dt"]


def _stack_out(rows, companion: bool, g_rows):
    return (torch.stack(rows[0]), torch.stack(rows[1]),
            torch.stack(g_rows) if companion else None)


def _check_prng_args(num_paths: int, num_steps: int, seed: int,
                     device) -> torch.device:
    device = torch.device(device)
    if num_paths < 1 or num_steps < 1:
        raise ValueError("need num_paths >= 1 and num_steps >= 1")
    _seed_words(seed)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    return device


def _launch_table_kernel(fn, consts: np.ndarray, lam_dt: float, seed: int,
                         num_paths: int, num_steps: int, n_branch: int,
                         companion: bool, device: torch.device, name: str):
    """Launch K3 or K4 (same C signature); returns (S, v, G or None)."""
    table = _device_table(float(lam_dt), int(num_steps), str(device))
    out = torch.empty((3 if companion else 2, n_branch, num_paths),
                      dtype=torch.float32, device=device)
    lib = load_library()
    with torch.cuda.device(device):
        rc = getattr(lib, fn)(
            out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr() if companion else None, table.data_ptr(),
            int(table.numel()), num_paths, num_steps, n_branch, int(seed),
            consts.ctypes.data, _stream_handle(device))
    _check_rc(lib, rc, name)
    return out[0], out[1], (out[2] if companion else None)


# ─────────────────────────────────────────────────────────────────────────────
# K3: SVJ Euler terminal state from an in-kernel generator
# ─────────────────────────────────────────────────────────────────────────────
def svj_terminal_plain(params: SVJParams, spot, T, seed: int, *,
                       num_paths: int, num_steps: int, antithetic: bool = True,
                       companion: bool = False, device="cpu"
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  Optional[torch.Tensor]]:
    """Plain torch version of K3 on the kernel's Philox words: call c of
    counter (pair_lo, pair_hi, c, 2) drives steps 2c and 2c+1, call
    ⌈steps/2⌉ the jump count and size; (n_branch, num_paths) outputs."""
    device = torch.device(device)
    consts = _svj_prng_consts(params, spot, T, num_steps)
    (spot_f, v0, _dt, sqrt_dt, _kappa, _theta, xi, rho, rho_perp, lam_dt,
     mu_j, sig_j, drift_dt, g_drift_dt, sig_cv, nhdt, omk, ktheta_dt) = (
        float(x) for x in consts)
    nb = 2 if antithetic else 1
    zeros = torch.zeros(num_paths, dtype=torch.float32, device=device)
    ls = [zeros] * nb
    v = [torch.full_like(zeros, max(v0, 0.0))] * nb
    cv_w = zeros

    def step(z1, z2):
        nonlocal cv_w
        dw1 = z1 * sqrt_dt
        dw2 = rho * dw1 + rho_perp * z2 * sqrt_dt
        for k in range(nb):
            s_dw1, s_dw2 = (dw1, dw2) if k == 0 else (-dw1, -dw2)
            sqrt_v = torch.sqrt(v[k])
            ls[k] = ls[k] + (drift_dt + nhdt * v[k]) + sqrt_v * s_dw1
            v[k] = torch.clamp(omk * v[k] + ktheta_dt
                               + xi * (sqrt_v * s_dw2), min=0.0)
        cv_w = cv_w + sig_cv * dw1

    n_calls = (num_steps + 1) // 2
    for call in range(n_calls):
        u = _pair_words(num_paths, call, _SVJ_DOMAIN, seed, device)
        step(*box_muller(u[0], u[1]))
        if 2 * call + 1 < num_steps:
            step(*box_muller(u[2], u[3]))
    u = _pair_words(num_paths, n_calls, _SVJ_DOMAIN, seed, device)
    n_jump = count_from_table(u[0], binom_count_table(lam_dt, num_steps))
    z_total, _ = box_muller(u[1], u[2])
    jump_mean = mu_j * n_jump
    jump_body = sig_j * torch.sqrt(n_jump) * z_total
    g_total = float(np.float32(g_drift_dt) * np.float32(num_steps))
    s_rows, g_rows = [], []
    for k in range(nb):
        sign_body, sign_w = ((jump_body, cv_w) if k == 0
                             else (-jump_body, -cv_w))
        s_rows.append(spot_f * torch.exp(ls[k] + jump_mean + sign_body))
        g_rows.append(spot_f * torch.exp(g_total + sign_w))
    return _stack_out((s_rows, v), companion, g_rows)


def svj_terminal(params: SVJParams, spot, T, seed: int, *, num_paths: int,
                 num_steps: int, antithetic: bool = True,
                 companion: bool = False, device="cuda"
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """K3 wrapper, the counterpart of `svj_terminal_pallas`: SVJ Euler
    terminal (S, v, G or None), each (n_branch, num_paths), row 0 the base
    branch, row 1 (antithetic) the negated normals. A CPU `device` takes the
    plain version; a CUDA one launches the kernel or raises."""
    device = _check_prng_args(num_paths, num_steps, seed, device)
    kw = dict(num_paths=num_paths, num_steps=num_steps,
              antithetic=antithetic, companion=companion)
    if device.type == "cpu":
        return svj_terminal_plain(params, spot, T, seed, device=device, **kw)
    consts = _svj_prng_consts(params, spot, T, num_steps)
    out = _launch_table_kernel(
        "mcos_svj_terminal", consts, consts[9], seed, num_paths, num_steps,
        2 if antithetic else 1, companion, device, "svj_terminal")
    with _COUNT_LOCK:
        svj_terminal.launches += 1
    return out


svj_terminal.launches = 0


# ─────────────────────────────────────────────────────────────────────────────
# K4: SVJ QE terminal state from an in-kernel generator
# ─────────────────────────────────────────────────────────────────────────────
def _qe_step_folded(v: torch.Tensor, z_v: torch.Tensor, u_v: torch.Tensor,
                    c: dict) -> torch.Tensor:
    """K4's variance transition (csrc/svj_qe.cu:qe_step): Andersen QE in
    the TPU kernel's division-folded algebra (pallas_kernels.py:
    _svj_qe_kernel). The quadratic branch a·(√b² + z_v)² for
    s² ≤ 1.5·m² on t = 2/ψ = 2m²/s², clipped to [1, 2e12], with
    b² = t − 1 + √(t(t − 1)); the exponential branch with mass
    p = (s² − m²)/(s² + m²) at 0 and tail
    m·log((1 − p)/(1 − u))/(1 − p).
    The law of `simulate.qe_variance_step` (K5's and the twins'), in one
    IEEE float32 operation per operation of the kernel."""
    m = c["theta"] + (v - c["theta"]) * c["e_kdt"]
    s2 = v * c["var1"] + c["var2"]
    m2 = m * m
    t = torch.clamp((2.0 * m2) / torch.clamp(s2, min=1e-30), min=1.0,
                    max=2e12)
    b2 = (t - 1.0) + torch.sqrt(t * (t - 1.0))
    x = torch.sqrt(b2) + z_v
    v_quad = (m / (1.0 + b2)) * (x * x)
    p_mass = torch.clamp((s2 - m2) / torch.clamp(s2 + m2, min=1e-30),
                         min=0.0, max=0.999)
    one_m_p = 1.0 - p_mass
    # A Python float clamps a float32 tensor at its float32 rounding.
    u_clip = torch.clamp(u_v, max=1.0 - 1e-7)
    v_exp = torch.where(u_v <= p_mass, torch.zeros_like(v),
                        (m * torch.log(one_m_p / (1.0 - u_clip))) / one_m_p)
    return torch.where(s2 <= 1.5 * m2, v_quad, v_exp)


def svj_terminal_qe_plain(params: SVJParams, spot, T, seed: int, *,
                          num_paths: int, num_steps: int,
                          antithetic: bool = True, companion: bool = False,
                          device="cpu"
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     Optional[torch.Tensor]]:
    """Plain torch version of K4 on the kernel's Philox words: step t takes
    counter (pair_lo, pair_hi, t, 3) (words 0, 1 → Box-Muller (z_x, z_v),
    word 2 the exponential branch's uniform) and the transition
    `_qe_step_folded`; call `num_steps` the jump count and size. v is
    shared by the pair: both rows are equal."""
    device = torch.device(device)
    consts = _qe_consts(params, spot, T, num_steps)
    c = _qe_dict(consts)
    nb = 2 if antithetic else 1
    zeros = torch.zeros(num_paths, dtype=torch.float32, device=device)
    ls, lg = [zeros] * nb, [zeros] * nb
    v = torch.full_like(zeros, c["v0"])
    for t in range(num_steps):
        u = _pair_words(num_paths, t, _QE_DOMAIN, seed, device)
        z_x, z_v = box_muller(u[0], u[1])
        v_next = _qe_step_folded(v, z_v, u[2], c)
        _qe_log_spot(c, v, v_next, ls, lg, z_x)
        v = v_next
    u = _pair_words(num_paths, num_steps, _QE_DOMAIN, seed, device)
    n_jump = count_from_table(u[0], binom_count_table(c["lam_dt"],
                                                      num_steps))
    z_total, _ = box_muller(u[1], u[2])
    jump_mean = c["mu_j"] * n_jump
    jump_body = c["sig_j"] * torch.sqrt(n_jump) * z_total
    s_rows = [c["spot"] * torch.exp(ls[k] + jump_mean
                                    + (jump_body if k == 0 else -jump_body))
              for k in range(nb)]
    g_rows = [c["spot"] * torch.exp(lg[k]) for k in range(nb)]
    return _stack_out((s_rows, [v] * nb), companion, g_rows)


def svj_terminal_qe(params: SVJParams, spot, T, seed: int, *,
                    num_paths: int, num_steps: int, antithetic: bool = True,
                    companion: bool = False, device="cuda"
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """K4 wrapper, the counterpart of `svj_terminal_qe_pallas`: Andersen QE
    terminal (S, v, G or None), each (n_branch, num_paths); the antithetic
    branch negates z_x and shares the variance path. A CPU `device` takes
    the plain version; a CUDA one launches the kernel or raises."""
    device = _check_prng_args(num_paths, num_steps, seed, device)
    kw = dict(num_paths=num_paths, num_steps=num_steps,
              antithetic=antithetic, companion=companion)
    if device.type == "cpu":
        return svj_terminal_qe_plain(params, spot, T, seed, device=device,
                                     **kw)
    consts = _qe_consts(params, spot, T, num_steps)
    out = _launch_table_kernel(
        "mcos_svj_terminal_qe", consts, consts[_QE_FIELDS.index("lam_dt")],
        seed, num_paths, num_steps, 2 if antithetic else 1, companion,
        device, "svj_terminal_qe")
    with _COUNT_LOCK:
        svj_terminal_qe.launches += 1
    return out


svj_terminal_qe.launches = 0


# ─────────────────────────────────────────────────────────────────────────────
# K5: SVJ QE terminal state from streamed draws
# ─────────────────────────────────────────────────────────────────────────────
def svj_terminal_qe_from_draws_plain(
    params: SVJParams, spot, T, z_x, u_v, u_jump, z_js, *, seed: int = 0,
    antithetic: bool = True, companion: bool = False,
    steps_major: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain torch version of K5: the same scalars, algebra (Acklam inverse
    of u_v, `qe_variance_step`) and output layout, one step at a time.
    u_jump=None draws the uniforms from `philox_jump_uniforms`."""
    z_x, u_v, z_js = (_steps_major(x, steps_major) for x in (z_x, u_v, z_js))
    num_steps, num_paths = z_x.shape
    if u_jump is None:
        u_jump = philox_jump_uniforms(num_steps, num_paths, seed, z_x.device)
    else:
        u_jump = _steps_major(u_jump, steps_major)
    c = _qe_dict(_qe_consts(params, spot, T, num_steps))
    nb = 2 if antithetic else 1
    zeros = torch.zeros(num_paths, dtype=torch.float32, device=z_x.device)
    ls, lg = [zeros] * nb, [zeros] * nb
    v = torch.full_like(zeros, c["v0"])
    for t in range(num_steps):
        v_next = qe_variance_step(v, ndtri_acklam(u_v[t]), u_v[t], c)
        jumped = u_jump[t] < c["lam_dt"]
        jump = [torch.where(jumped, c["mu_j"] + c["sig_j"] * sz_j,
                            torch.zeros_like(sz_j))
                for sz_j in (z_js[t], -z_js[t])[:nb]]
        _qe_log_spot(c, v, v_next, ls, lg, z_x[t], jump)
        v = v_next
    s_rows = [c["spot"] * torch.exp(x) for x in ls]
    g_rows = [c["spot"] * torch.exp(x) for x in lg]
    return _stack_out((s_rows, [v] * nb), companion, g_rows)


def svj_terminal_qe_from_draws(
    params: SVJParams, spot, T, z_x: torch.Tensor, u_v: torch.Tensor,
    u_jump: Optional[torch.Tensor], z_js: torch.Tensor, *, seed: int = 0,
    antithetic: bool = True, companion: bool = False,
    steps_major: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """K5 wrapper, the counterpart of `svj_terminal_qe_from_draws_pallas`.

    Args:
        z_x, u_v, z_js, u_jump: float32 draws, (num_steps, num_paths) with
            `steps_major=True` (what `sobol_qe_draws` gives) or
            (num_paths, num_steps): log-spot normals, variance-transition
            uniforms in (0, 1), jump-size normals, jump uniforms.
            u_jump=None draws the jump uniforms in-kernel from K1's Philox
            stream keyed on `seed`.
    Returns:
        (S, v, G or None), each (n_branch, num_paths); the antithetic row
        negates z_x and z_js and shares u_v and u_jump, so both v rows are
        equal.
    """
    draws = {"z_x": z_x, "u_v": u_v, "z_js": z_js}
    if u_jump is not None:
        draws["u_jump"] = u_jump
    for name, x in draws.items():
        _check_draw(name, x, z_x)
    if z_x.dim() != 2 or z_x.numel() == 0:
        raise ValueError(f"draws must be non-empty 2-D, got {tuple(z_x.shape)}")
    if z_x.device.type == "cpu":
        return svj_terminal_qe_from_draws_plain(
            params, spot, T, z_x, u_v, u_jump, z_js, seed=seed,
            antithetic=antithetic, companion=companion,
            steps_major=steps_major)
    if z_x.device.type != "cuda":
        raise ValueError(f"no kernel for device {z_x.device}")

    draws = {k: _steps_major(x, steps_major).contiguous()
             for k, x in draws.items()}
    num_steps, num_paths = draws["z_x"].shape
    n_branch = 2 if antithetic else 1
    _seed_words(seed)
    consts = _qe_consts(params, spot, T, num_steps)
    out = torch.empty((3 if companion else 2, n_branch, num_paths),
                      dtype=torch.float32, device=z_x.device)
    lib = load_library()
    with torch.cuda.device(z_x.device):
        rc = lib.mcos_svj_terminal_qe_from_draws(
            draws["z_x"].data_ptr(), draws["u_v"].data_ptr(),
            draws["z_js"].data_ptr(),
            draws["u_jump"].data_ptr() if u_jump is not None else None,
            out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr() if companion else None,
            num_paths, num_steps, n_branch, int(seed),
            consts.ctypes.data, _stream_handle(z_x.device))
    _check_rc(lib, rc, "svj_terminal_qe_from_draws")
    with _COUNT_LOCK:
        svj_terminal_qe_from_draws.launches += 1
    return out[0], out[1], (out[2] if companion else None)


svj_terminal_qe_from_draws.launches = 0


# ─────────────────────────────────────────────────────────────────────────────
# K6: SVJ path statistics from an in-kernel generator
# ─────────────────────────────────────────────────────────────────────────────
_STATS_ROWS = ("s_final", "avg", "log_avg", "max_s", "min_s", "log_surv")
_STATS_G_ROWS = ("g_final", "g_avg", "g_log_avg", "g_max", "g_min",
                 "g_log_surv")
# Bridge modes of csrc/svj_stats.cu.
_NO_BRIDGE, _BRIDGE_UP, _BRIDGE_DOWN, _CORRIDOR = 0, 1, 2, 3


def _stats_consts(params: SVJParams, spot, T, num_steps: int,
                  bridge_log_b=0.0, bridge_log_l=0.0) -> np.ndarray:
    """The 33 float32 scalars of csrc/svj_stats.cu:StatsConsts: `_svj_consts`
    (the arithmetic of `_pack_params`), the barrier logs log(B/S0) and
    log(L/S0), 1/steps; then the launch constants the kernel would
    otherwise compute in every thread, by its own IEEE float32 operations
    (numpy's float32 products, differences and quotients round as
    `__fmul_rn`, `__fsub_rn` and `__frcp_rn` do; `np.fmax` ignores a NaN as
    `fmaxf` does): the corridor's width d = log_b − log_l, 2n·d and n·d for
    n = −2..2, and the companion's step variance max(σ_cv²·dt, 1e−20),
    twice it and the two reciprocals."""
    f = np.float32
    base = _svj_consts(params, spot, T, num_steps)
    dt, sig_cv = base[2], base[14]
    log_b, log_l = f(bridge_log_b), f(bridge_log_l)
    width = log_b - log_l
    g_s = np.fmax((sig_cv * sig_cv) * dt, f(1e-20))
    g_two_s = f(2.0) * g_s
    extra = ((log_b, log_l, f(1.0) / f(num_steps), width)
             + tuple(f(2 * n) * width for n in range(-2, 3))
             + tuple(f(n) * width for n in range(-2, 3))
             + (g_s, g_two_s, f(1.0) / g_s, f(1.0) / g_two_s))
    return np.concatenate([base, np.asarray(extra, np.float32)])


def _stats_mode(bridge: bool, bridge_up: bool, corridor: bool) -> int:
    if corridor and not bridge:
        raise ValueError("corridor=True needs bridge=True")
    if not bridge:
        return _NO_BRIDGE
    if corridor:
        return _CORRIDOR
    return _BRIDGE_UP if bridge_up else _BRIDGE_DOWN


def _stats_window(window, bridge: bool, num_steps: int) -> Tuple[int, int]:
    if window is None:
        return 0, num_steps
    if not bridge:
        raise ValueError("window needs bridge=True")
    w0, w1 = int(window[0]), int(window[1])
    if not 0 <= w0 < w1 <= num_steps:
        raise ValueError(f"window needs 0 <= w0 < w1 <= {num_steps}, got "
                         f"({w0}, {w1})")
    return w0, w1


def _stats_names(mode: int, companion: bool) -> Tuple[str, ...]:
    keep = 5 if mode == _NO_BRIDGE else 6
    return _STATS_ROWS[:keep] + (_STATS_G_ROWS[:keep] if companion else ())


def svj_path_stats_plain(params: SVJParams, spot, T, seed: int, *,
                         num_paths: int, num_steps: int,
                         antithetic: bool = True, companion: bool = True,
                         bridge: bool = False, bridge_up: bool = True,
                         bridge_log_b=0.0, corridor: bool = False,
                         bridge_log_l=0.0, window=None, device="cpu"
                         ) -> Dict[str, torch.Tensor]:
    """Plain torch version of K6 on the kernel's Philox words: steps 2i and
    2i+1 take calls 2i and 2i+1 of counter (pair_lo, pair_hi, call, 4),
    three Box-Muller pairs and two jump uniforms; an odd last step takes
    calls steps−1 and steps. Each float32 operation on the carries and in
    the survival increments is the kernel's, in its order, so on the card
    the two agree bit for bit on which paths are dead. Returns the dict of
    `svj_path_stats`."""
    device = torch.device(device)
    mode = _stats_mode(bridge, bridge_up, corridor)
    w0, w1 = _stats_window(window, bridge, num_steps)
    consts = _stats_consts(params, spot, T, num_steps, bridge_log_b,
                           bridge_log_l)
    (spot_f, v0, dt, sqrt_dt, kappa, theta, xi, rho, rho_perp, lam_dt, mu_j,
     sig_j, drift_dt, g_drift_dt, sig_cv, _log_b, _log_l, inv_n) = (
        float(x) for x in consts[:18])
    # 0-d float32 tensors where the survival increments take tensors.
    dt_t, log_b, log_l, sig_cv_t, spot_t = (
        torch.tensor(x, dtype=torch.float32, device=device)
        for x in (dt, _log_b, _log_l, sig_cv, spot_f))
    g_var = sig_cv_t * sig_cv_t
    nb = 2 if antithetic else 1
    zeros = torch.zeros(num_paths, dtype=torch.float32, device=device)
    neg_inf = torch.full_like(zeros, -torch.inf)
    leg = dict(x=zeros, sum_s=zeros, sum_l=zeros, max_l=neg_inf,
               min_l=-neg_inf, surv=zeros)
    svj = [dict(leg, v=torch.full_like(zeros, v0)) for _ in range(nb)]
    gbm = [dict(leg) for _ in range(nb)]

    def surv_inc(x_old, x_new, var_step):
        if mode == _CORRIDOR:
            return corridor_surv_increment(x_old, x_new, var_step, dt_t,
                                           log_l, log_b)
        return single_surv_increment(x_old, x_new, var_step, dt_t, log_b,
                                     mode == _BRIDGE_UP)

    def track(st, x_prev, x, var_step, in_win):
        st["x"] = x
        st["sum_s"] = st["sum_s"] + torch.exp(x)
        st["sum_l"] = st["sum_l"] + x
        st["max_l"] = torch.maximum(st["max_l"], x)
        st["min_l"] = torch.minimum(st["min_l"], x)
        if mode != _NO_BRIDGE and in_win:
            st["surv"] = st["surv"] + surv_inc(x_prev, x, var_step)

    def step(idx, z1, z2, z_js, u_jump):
        in_win = w0 <= idx < w1
        dw1 = z1 * sqrt_dt
        dw2 = rho * dw1 + rho_perp * z2 * sqrt_dt
        jumped = u_jump < lam_dt
        jump_body = sig_j * z_js
        cv_dw = sig_cv * dw1
        for k in range(nb):
            s_dw1, s_dw2, s_body, s_cv = (
                (dw1, dw2, jump_body, cv_dw) if k == 0
                else (-dw1, -dw2, -jump_body, -cv_dw))
            st = svj[k]
            v_pos = torch.clamp(st["v"], min=0.0)
            sqrt_v = torch.sqrt(v_pos)
            jump = torch.where(jumped, mu_j + s_body,
                               torch.zeros_like(s_body))
            x_prev = st["x"]
            x = (x_prev + (drift_dt - 0.5 * v_pos * dt) + sqrt_v * s_dw1
                 + jump)
            st["v"] = torch.clamp(v_pos + kappa * (theta - v_pos) * dt
                                  + xi * sqrt_v * s_dw2, min=0.0)
            track(st, x_prev, x, torch.clamp(v_pos, min=1e-12), in_win)
            if companion:
                g_prev = gbm[k]["x"]
                track(gbm[k], g_prev, g_prev + g_drift_dt + s_cv, g_var,
                      in_win)

    def uniforms(call):
        return _pair_words(num_paths, call, _STATS_DOMAIN, seed, device)

    for i in range(0, num_steps - 1, 2):
        a, b = uniforms(i), uniforms(i + 1)
        z_a, z_b = box_muller(a[0], a[1])
        z_c, z_d = box_muller(a[2], a[3])
        z_e, z_f = box_muller(b[0], b[1])
        step(i, z_a, z_b, z_c, b[2])
        step(i + 1, z_d, z_e, z_f, b[3])
    if num_steps % 2 == 1:
        a, b = uniforms(num_steps - 1), uniforms(num_steps)
        z1, z2 = box_muller(a[0], a[1])
        z_js, _ = box_muller(a[2], a[3])
        step(num_steps - 1, z1, z2, z_js, b[0])

    log_spot = torch.log(spot_t)

    def rows(legs):
        out = [spot_f * torch.exp(torch.stack([st["x"] for st in legs])),
               spot_f * (torch.stack([st["sum_s"] for st in legs]) * inv_n),
               log_spot + torch.stack([st["sum_l"] for st in legs]) * inv_n,
               spot_f * torch.exp(torch.stack([st["max_l"] for st in legs])),
               spot_f * torch.exp(torch.stack([st["min_l"] for st in legs]))]
        if mode != _NO_BRIDGE:
            out.append(torch.stack([st["surv"] for st in legs]))
        return out

    values = rows(svj) + (rows(gbm) if companion else [])
    return dict(zip(_stats_names(mode, companion), values))


def svj_path_stats(params: SVJParams, spot, T, seed: int, *, num_paths: int,
                   num_steps: int, antithetic: bool = True,
                   companion: bool = True, bridge: bool = False,
                   bridge_up: bool = True, bridge_log_b=0.0,
                   corridor: bool = False, bridge_log_l=0.0, window=None,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """K6 wrapper, the counterpart of `svj_path_stats_pallas`: SVJ Euler
    paths (one Bernoulli jump test per step) with running functionals.

    Returns a dict of (n_branch, num_paths) float32 tensors: s_final, avg,
    log_avg, max_s, min_s; with companion=True the GBM leg's g_final,
    g_avg, g_log_avg, g_max, g_min; with bridge=True the Brownian-bridge
    log-survival weights log_surv (and g_log_surv) against the barrier at
    log(B/S0) = `bridge_log_b` (above the spot with `bridge_up`, else
    below), or with corridor=True against exit from (`bridge_log_l`,
    `bridge_log_b`). window=(w0, w1) restricts the bridge to the steps
    w0..w1−1. A CPU `device` takes the plain version; a CUDA one launches
    the kernel or raises."""
    device = _check_prng_args(num_paths, num_steps, seed, device)
    kw = dict(num_paths=num_paths, num_steps=num_steps,
              antithetic=antithetic, companion=companion, bridge=bridge,
              bridge_up=bridge_up, bridge_log_b=bridge_log_b,
              corridor=corridor, bridge_log_l=bridge_log_l, window=window)
    if device.type == "cpu":
        return svj_path_stats_plain(params, spot, T, seed, device=device,
                                    **kw)
    mode = _stats_mode(bridge, bridge_up, corridor)
    w0, w1 = _stats_window(window, bridge, num_steps)
    consts = _stats_consts(params, spot, T, num_steps, bridge_log_b,
                           bridge_log_l)
    names = _stats_names(mode, companion)
    n_branch = 2 if antithetic else 1
    out = torch.empty((len(names), n_branch, num_paths), dtype=torch.float32,
                      device=device)
    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.mcos_svj_path_stats(
            out.data_ptr(), num_paths, num_steps, n_branch, mode,
            int(companion), w0, w1, int(seed), consts.ctypes.data,
            _stream_handle(device))
    _check_rc(lib, rc, "svj_path_stats")
    key = (mode, bool(companion), num_steps, w0, w1, n_branch)
    with _COUNT_LOCK:
        svj_path_stats.launches += 1
        svj_path_stats.variants[key] = svj_path_stats.variants.get(key, 0) + 1
    return dict(zip(names, out))


svj_path_stats.launches = 0
# The launches by variant, (mode, companion, steps, w0, w1, n_branch): a
# variant's time depends on these, so a run can price its launches.
svj_path_stats.variants = {}


# ─────────────────────────────────────────────────────────────────────────────
# K7: Heston-Hull-White terminal spot and discount factor
# ─────────────────────────────────────────────────────────────────────────────
def _hhw_consts(params: HHWParams, spot, T, num_steps: int) -> np.ndarray:
    """The 17 float32 scalars of csrc/hhw.cu:HhwConsts, in the order of
    mcos_tpu/ops/pallas_kernels.py:_H_SPOT.._H_L33, computed in float64 and
    cast once. The Cholesky rows come from `hhw_cholesky`, which raises
    ValueError for a correlation matrix that is not positive definite;
    s_ou keeps the reference's max(2a, 1e-12) divisor."""
    p = params
    chol = hhw_cholesky(p)
    dt = float(T) / num_steps
    a = float(p.a)
    e_adt = math.exp(-a * dt)
    s_ou = float(p.sigma_r) * math.sqrt((1.0 - e_adt**2)
                                        / max(2.0 * a, 1e-12))
    vals = (float(spot), dt, math.sqrt(dt), float(p.kappa), float(p.theta),
            float(p.xi), float(p.v0), float(p.q), e_adt, s_ou, float(p.b),
            float(p.r0), chol[1, 0], chol[1, 1], chol[2, 0], chol[2, 1],
            chol[2, 2])
    return np.asarray(vals, np.float32)


def hhw_terminal_plain(params: HHWParams, spot, T, seed: int, *,
                       num_paths: int, num_steps: int,
                       antithetic: bool = True, device="cpu"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K7 on the kernel's Philox words: steps 2i and
    2i+1 take calls 2i and 2i+1 of counter (pair_lo, pair_hi, call, 5):
    words a0..a3, b0, b1 give three Box-Muller pairs (z_a, z_b), (z_c, z_d),
    (z_e, z_f); step 2i runs on (z_a, z_b, z_c), step 2i+1 on (z_d, z_e,
    z_f); b2, b3 are spare. An odd last step takes call steps−1 alone:
    (z1, z2) from a0, a1 and z3 from a2, a3. Each float32 operation on the
    carries is the kernel's, in its order. Returns (S, D), each
    (n_branch, num_paths)."""
    device = torch.device(device)
    (spot_f, dt, sqrt_dt, kappa, theta, xi, v0, q, e_adt, s_ou, b, r0, l21,
     l22, l31, l32, l33) = (
        float(x) for x in _hhw_consts(params, spot, T, num_steps))
    nb = 2 if antithetic else 1
    zeros = torch.zeros(num_paths, dtype=torch.float32, device=device)
    ls, int_r = [zeros] * nb, [zeros] * nb
    v = [torch.full_like(zeros, v0)] * nb
    r = [torch.full_like(zeros, r0)] * nb

    def step(z1, z2, z3):
        zv = l21 * z1 + l22 * z2
        zr = (l31 * z1 + l32 * z2) + l33 * z3
        dw1, dwv, ou = z1 * sqrt_dt, zv * sqrt_dt, s_ou * zr
        for k in range(nb):
            s_dw1, s_dwv, s_ou_k = ((dw1, dwv, ou) if k == 0
                                    else (-dw1, -dwv, -ou))
            v_pos = torch.clamp(v[k], min=0.0)
            sqrt_v = torch.sqrt(v_pos)
            drift = ((r[k] - q) - 0.5 * v_pos) * dt
            ls[k] = ls[k] + (drift + sqrt_v * s_dw1)
            v[k] = torch.clamp(
                (v_pos + (kappa * (theta - v_pos)) * dt)
                + (xi * sqrt_v) * s_dwv, min=0.0)
            int_r[k] = int_r[k] + r[k] * dt                 # left point
            r[k] = (b + (r[k] - b) * e_adt) + s_ou_k

    def uniforms(call):
        return _pair_words(num_paths, call, _HHW_DOMAIN, seed, device)

    for i in range(0, num_steps - 1, 2):
        a, c = uniforms(i), uniforms(i + 1)
        z_a, z_b = box_muller(a[0], a[1])
        z_c, z_d = box_muller(a[2], a[3])
        z_e, z_f = box_muller(c[0], c[1])
        step(z_a, z_b, z_c)
        step(z_d, z_e, z_f)
    if num_steps % 2 == 1:
        a = uniforms(num_steps - 1)
        z1, z2 = box_muller(a[0], a[1])
        z3, _ = box_muller(a[2], a[3])
        step(z1, z2, z3)
    return (spot_f * torch.exp(torch.stack(ls)),
            torch.exp(-torch.stack(int_r)))


def hhw_terminal(params: HHWParams, spot, T, seed: int, *, num_paths: int,
                 num_steps: int, antithetic: bool = True, device="cuda"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 wrapper, the counterpart of `hhw_terminal_pallas`: terminal spots
    and pathwise discount factors exp(−∫r dt) of the Heston-Hull-White
    hybrid, each (n_branch, num_paths), row 0 the base branch, row 1
    (antithetic) all three normals negated. The normals depend on (seed,
    pair, step) only, so two parameter sets on one seed share their random
    numbers. A CPU `device` takes the plain version; a CUDA one launches
    the kernel or raises. ValueError for a correlation matrix that is not
    positive definite."""
    device = _check_prng_args(num_paths, num_steps, seed, device)
    if device.type == "cpu":
        return hhw_terminal_plain(params, spot, T, seed, num_paths=num_paths,
                                  num_steps=num_steps, antithetic=antithetic,
                                  device=device)
    consts = _hhw_consts(params, spot, T, num_steps)
    n_branch = 2 if antithetic else 1
    out = torch.empty((2, n_branch, num_paths), dtype=torch.float32,
                      device=device)
    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.mcos_hhw_terminal(
            out[0].data_ptr(), out[1].data_ptr(), num_paths, num_steps,
            n_branch, int(seed), consts.ctypes.data, _stream_handle(device))
    _check_rc(lib, rc, "hhw_terminal")
    with _COUNT_LOCK:
        hhw_terminal.launches += 1
    return out[0], out[1]


hhw_terminal.launches = 0


# ─────────────────────────────────────────────────────────────────────────────
# K8: SVCJ terminal state (correlated jumps in price and variance)
# ─────────────────────────────────────────────────────────────────────────────
def _svcj_consts(params: SVCJParams, spot, T, num_steps: int) -> np.ndarray:
    """The 17 float32 scalars of csrc/svcj.cu:SvcjConsts, in the order of
    mcos_tpu/ops/pallas_kernels.py:_C_SPOT.._C_SIG_CV, computed in float64
    and cast once."""
    p = params
    dt = float(T) / num_steps
    k_bar = (math.exp(float(p.mu_j) + 0.5 * float(p.sigma_j) ** 2)
             / (1.0 - float(p.rho_j) * float(p.mu_v)) - 1.0)
    with np.errstate(all="ignore"):
        sigma_cv = float(np.sqrt(np.float64(p.v0)))
        rho_perp = float(np.sqrt(np.float64(1.0 - float(p.rho) ** 2)))
    vals = (float(spot), float(p.v0), dt, math.sqrt(dt), float(p.kappa),
            float(p.theta), float(p.xi), float(p.rho), rho_perp,
            float(p.lambda_j) * dt, float(p.mu_j), float(p.sigma_j),
            float(p.mu_v), float(p.rho_j),
            (float(p.r) - float(p.q) - float(p.lambda_j) * k_bar) * dt,
            (float(p.r) - float(p.q) - 0.5 * sigma_cv**2) * dt, sigma_cv)
    return np.asarray(vals, np.float32)


def svcj_terminal_plain(params: SVCJParams, spot, T, seed: int, *,
                        num_paths: int, num_steps: int,
                        antithetic: bool = True, companion: bool = False,
                        device="cpu"
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   Optional[torch.Tensor]]:
    """Plain torch version of K8 on the kernel's Philox words: steps 2i and
    2i+1 take calls 3i, 3i+1, 3i+2 of counter (pair_lo, pair_hi, call, 6):
    a0..a3 the Box-Muller pairs (z1, z2) of the two steps, b0, b1 the pair
    of jump-size normals, b2, b3 the two jump uniforms, c0, c1 the two
    exponential uniforms (the variance jump is −μ_v·log(u), u strictly
    inside (0, 1)). An odd last step takes calls 3⌊steps/2⌋ and the next:
    (z1, z2) from a0, a1, z_js from a2, a3, jump uniform b0, exponential
    uniform b1. Each float32 operation on the carries is the kernel's, in
    its order. Returns (S, v, G or None), each (n_branch, num_paths)."""
    device = torch.device(device)
    (spot_f, v0, dt, sqrt_dt, kappa, theta, xi, rho, rho_perp, lam_dt, mu_j,
     sig_j, mu_v, rho_j, drift_dt, g_drift_dt, sig_cv) = (
        float(x) for x in _svcj_consts(params, spot, T, num_steps))
    nb = 2 if antithetic else 1
    zeros = torch.zeros(num_paths, dtype=torch.float32, device=device)
    ls = [zeros] * nb
    v = [torch.full_like(zeros, v0)] * nb
    cv_w = zeros

    def step(z1, z2, z_js, u_jump, u_exp):
        nonlocal cv_w
        dw1 = z1 * sqrt_dt
        dw2 = rho * dw1 + (rho_perp * z2) * sqrt_dt
        jumped = u_jump < lam_dt
        jump_v = torch.where(jumped, mu_v * (-torch.log(u_exp)), zeros)
        jump_base = torch.where(jumped, mu_j + rho_j * jump_v, zeros)
        jump_odd = torch.where(jumped, sig_j * z_js, zeros)
        for k in range(nb):
            s_dw1, s_dw2, s_odd = ((dw1, dw2, jump_odd) if k == 0
                                   else (-dw1, -dw2, -jump_odd))
            v_pos = torch.clamp(v[k], min=0.0)
            sqrt_v = torch.sqrt(v_pos)
            x = ls[k] + (drift_dt - (0.5 * v_pos) * dt)
            x = x + sqrt_v * s_dw1
            ls[k] = (x + jump_base) + s_odd
            w = v_pos + (kappa * (theta - v_pos)) * dt
            w = w + (xi * sqrt_v) * s_dw2
            v[k] = torch.clamp(w + jump_v, min=0.0)
        cv_w = cv_w + sig_cv * dw1

    def uniforms(call):
        return _pair_words(num_paths, call, _SVCJ_DOMAIN, seed, device)

    call = 0
    for _ in range(num_steps // 2):
        a, b, c = uniforms(call), uniforms(call + 1), uniforms(call + 2)
        z1a, z2a = box_muller(a[0], a[1])
        z1b, z2b = box_muller(a[2], a[3])
        zja, zjb = box_muller(b[0], b[1])
        step(z1a, z2a, zja, b[2], c[0])
        step(z1b, z2b, zjb, b[3], c[1])
        call += 3
    if num_steps % 2 == 1:
        a, b = uniforms(call), uniforms(call + 1)
        z1, z2 = box_muller(a[0], a[1])
        z_js, _ = box_muller(a[2], a[3])
        step(z1, z2, z_js, b[0], b[1])
    g_total = float(np.float32(g_drift_dt) * np.float32(num_steps))
    s_rows = [spot_f * torch.exp(x) for x in ls]
    g_rows = [spot_f * torch.exp(g_total + (cv_w if k == 0 else -cv_w))
              for k in range(nb)]
    return _stack_out((s_rows, v), companion, g_rows)


def svcj_terminal(params: SVCJParams, spot, T, seed: int, *, num_paths: int,
                  num_steps: int, antithetic: bool = True,
                  companion: bool = False, device="cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor]]:
    """K8 wrapper, the counterpart of `svcj_terminal_pallas`: SVCJ Euler
    terminal (S, v, G or None), each (n_branch, num_paths); the antithetic
    row negates the normals and shares the jump uniforms and the
    exponential variance jumps. A CPU `device` takes the plain version; a
    CUDA one launches the kernel or raises."""
    device = _check_prng_args(num_paths, num_steps, seed, device)
    if device.type == "cpu":
        return svcj_terminal_plain(
            params, spot, T, seed, num_paths=num_paths, num_steps=num_steps,
            antithetic=antithetic, companion=companion, device=device)
    consts = _svcj_consts(params, spot, T, num_steps)
    n_branch = 2 if antithetic else 1
    out = torch.empty((3 if companion else 2, n_branch, num_paths),
                      dtype=torch.float32, device=device)
    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.mcos_svcj_terminal(
            out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr() if companion else None, num_paths, num_steps,
            n_branch, int(seed), consts.ctypes.data, _stream_handle(device))
    _check_rc(lib, rc, "svcj_terminal")
    with _COUNT_LOCK:
        svcj_terminal.launches += 1
    return out[0], out[1], (out[2] if companion else None)


svcj_terminal.launches = 0


# ─────────────────────────────────────────────────────────────────────────────
# K9: SVJ terminal state under piecewise-constant θ(t), ξ(t), λ(t)
# ─────────────────────────────────────────────────────────────────────────────
def _td_consts(params: SVJParams, theta_t, xi_t, lam_t, spot, T,
               num_steps: int):
    """(the 12 float32 scalars of csrc/svj_td.cu:TdConsts, the (4, steps)
    float32 table with rows (θᵢ, ξᵢ, λᵢ·dt, drift_dtᵢ), the float64 per-step
    jump probabilities λᵢ·dt), computed in float64 and cast once."""
    p = params
    levels = []
    for name, x in (("theta_t", theta_t), ("xi_t", xi_t), ("lam_t", lam_t)):
        arr = np.asarray(x, np.float64).reshape(-1)
        if arr.size != num_steps:
            raise ValueError(f"{name} has {arr.size} entries for "
                             f"{num_steps} steps")
        levels.append(arr)
    theta, xi, lam = levels
    dt = float(T) / num_steps
    k_bar = math.exp(float(p.mu_j) + 0.5 * float(p.sigma_j) ** 2) - 1.0
    with np.errstate(all="ignore"):
        sigma_cv = float(np.sqrt(np.float64(p.v0)))
        rho_perp = float(np.sqrt(np.float64(1.0 - float(p.rho) ** 2)))
    kappa = float(p.kappa)
    consts = np.asarray((
        float(spot), float(p.v0), math.sqrt(dt), float(p.rho), rho_perp,
        float(p.mu_j), float(p.sigma_j),
        (float(p.r) - float(p.q) - 0.5 * sigma_cv**2) * dt, sigma_cv,
        -0.5 * dt, 1.0 - kappa * dt, kappa * dt), np.float32)
    lam_dt = lam * dt
    table = np.stack([theta, xi, lam_dt,
                      (float(p.r) - float(p.q) - lam * k_bar) * dt])
    return consts, np.ascontiguousarray(table, np.float32), lam_dt


def svj_terminal_td_plain(params: SVJParams, theta_t, xi_t, lam_t, spot, T,
                          seed: int, *, num_paths: int, num_steps: int,
                          antithetic: bool = True, companion: bool = False,
                          device="cpu"
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     Optional[torch.Tensor]]:
    """Plain torch version of K9 on the kernel's Philox words, K3's layout
    in domain 7: call c of counter (pair_lo, pair_hi, c, 7) drives steps 2c
    and 2c+1, call ⌈steps/2⌉ the jump count (word 0, inverted through
    `poisson_binom_count_table`) and size (words 1, 2). The variance carry
    starts at max(v0, 0). Each float32 operation on the carries is the
    kernel's, in its order. Returns (S, v, G or None), each
    (n_branch, num_paths)."""
    device = torch.device(device)
    consts, table, lam_dt = _td_consts(params, theta_t, xi_t, lam_t, spot, T,
                                       num_steps)
    (spot_f, v0, sqrt_dt, rho, rho_perp, mu_j, sig_j, g_drift_dt, sig_cv,
     nhdt, omk, _kappa_dt) = (float(x) for x in consts)
    ktheta_dt = consts[11] * table[0]          # float32 products, as fmul
    nb = 2 if antithetic else 1
    zeros = torch.zeros(num_paths, dtype=torch.float32, device=device)
    ls = [zeros] * nb
    v = [torch.full_like(zeros, max(v0, 0.0))] * nb
    cv_w = zeros

    def step(idx, z1, z2):
        nonlocal cv_w
        xi_i, drift_i = float(table[1, idx]), float(table[3, idx])
        kth = float(ktheta_dt[idx])
        dw1 = z1 * sqrt_dt
        dw2 = rho * dw1 + (rho_perp * z2) * sqrt_dt
        for k in range(nb):
            s_dw1, s_dw2 = (dw1, dw2) if k == 0 else (-dw1, -dw2)
            sqrt_v = torch.sqrt(v[k])
            ls[k] = (ls[k] + (drift_i + nhdt * v[k])) + sqrt_v * s_dw1
            v[k] = torch.clamp((omk * v[k] + kth)
                               + xi_i * (sqrt_v * s_dw2), min=0.0)
        cv_w = cv_w + sig_cv * dw1

    n_calls = (num_steps + 1) // 2
    for call in range(n_calls):
        u = _pair_words(num_paths, call, _TD_DOMAIN, seed, device)
        step(2 * call, *box_muller(u[0], u[1]))
        if 2 * call + 1 < num_steps:
            step(2 * call + 1, *box_muller(u[2], u[3]))
    u = _pair_words(num_paths, n_calls, _TD_DOMAIN, seed, device)
    n_jump = count_from_table(u[0], poisson_binom_count_table(lam_dt))
    z_total, _ = box_muller(u[1], u[2])
    jump_mean = mu_j * n_jump
    jump_body = (sig_j * torch.sqrt(n_jump)) * z_total
    g_total = float(np.float32(g_drift_dt) * np.float32(num_steps))
    s_rows, g_rows = [], []
    for k in range(nb):
        sign_body, sign_w = ((jump_body, cv_w) if k == 0
                             else (-jump_body, -cv_w))
        s_rows.append(spot_f * torch.exp((ls[k] + jump_mean) + sign_body))
        g_rows.append(spot_f * torch.exp(g_total + sign_w))
    return _stack_out((s_rows, v), companion, g_rows)


def svj_terminal_td(params: SVJParams, theta_t, xi_t, lam_t, spot, T,
                    seed: int, *, num_paths: int, num_steps: int,
                    antithetic: bool = True, companion: bool = False,
                    device="cuda"
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """K9 wrapper, the counterpart of `svj_terminal_td_pallas`: SVJ Euler
    terminal (S, v, G or None), each (n_branch, num_paths), under the
    (num_steps,) per-step levels `theta_t`, `xi_t`, `lam_t`
    (`tdsvj.step_param_arrays`; `params`' own θ, ξ, λ are not read). The
    jump count is drawn once per path from the Poisson-binomial law of the
    per-step λᵢ·dt. A CPU `device` takes the plain version; a CUDA one
    launches the kernel or raises."""
    device = _check_prng_args(num_paths, num_steps, seed, device)
    if device.type == "cpu":
        return svj_terminal_td_plain(
            params, theta_t, xi_t, lam_t, spot, T, seed, num_paths=num_paths,
            num_steps=num_steps, antithetic=antithetic, companion=companion,
            device=device)
    consts, table, lam_dt = _td_consts(params, theta_t, xi_t, lam_t, spot, T,
                                       num_steps)
    cdf = _device_td_table(lam_dt.tobytes(), str(device))
    table_dev = _device_step_table(table.tobytes(), num_steps, str(device))
    n_branch = 2 if antithetic else 1
    out = torch.empty((3 if companion else 2, n_branch, num_paths),
                      dtype=torch.float32, device=device)
    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.mcos_svj_terminal_td(
            out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr() if companion else None, table_dev.data_ptr(),
            cdf.data_ptr(), int(cdf.numel()), num_paths, num_steps, n_branch,
            int(seed), consts.ctypes.data, _stream_handle(device))
    _check_rc(lib, rc, "svj_terminal_td")
    with _COUNT_LOCK:
        svj_terminal_td.launches += 1
    return out[0], out[1], (out[2] if companion else None)


svj_terminal_td.launches = 0


# ─────────────────────────────────────────────────────────────────────────────
# K10, K11: rough Bergomi Markovian lift (integrals; path statistics)
# ─────────────────────────────────────────────────────────────────────────────
_MAX_FACTORS = 32     # csrc/rbergomi_lift.cu, rbergomi_stats.cu: kMaxFactors


def _rough_tables(eta, xi_flat, hurst: float, T, num_steps: int, c, d, g,
                  tail, xi_t=None, spot_leg=None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The launch scalars, the (3, m) factor table and the (2, steps) step
    table of K10/K11, computed in float64 on the host and cast once.

    scalars: [eta, sqrt_dt, dt], and with `spot_leg` = (rho, r, q) also
    [rho, orth = sqrt(max(1 - rho^2, 0)), mu_dt = (r - q) dt, 1/steps];
    factor table: rows c, d, g (`ops/rough.py:rbergomi_lift`);
    step table: rows e_i = ln xi_i - eta^2/2 t_i^{2H} and sqrt(tail_{i-1})
    at the left points t_i = i dt (t_0 row first: t^{2H} = 0 and the tail
    0 there), with xi_i from `xi_t` or the flat `xi_flat`."""
    n = int(num_steps)
    cdg = np.ascontiguousarray(np.stack([np.asarray(x, np.float32).reshape(-1)
                                         for x in (c, d, g)]))
    m = cdg.shape[1]
    if not 1 <= m <= _MAX_FACTORS:
        raise ValueError(f"the lift kernels take 1..{_MAX_FACTORS} factors, "
                         f"got {m}")
    tail = np.asarray(tail, np.float64).reshape(-1)
    if tail.size != n:
        raise ValueError(f"tail has {tail.size} entries for {n} steps")
    eta = float(eta)
    dt = float(T) / n
    wick_left = (dt * np.arange(n)) ** (2.0 * float(hurst))
    xi = (np.full(n, float(xi_flat)) if xi_t is None
          else np.asarray(xi_t, np.float64).reshape(-1))
    if xi.size != n:
        raise ValueError(f"xi_t has {xi.size} entries for {n} steps")
    e_tab = np.log(xi) - 0.5 * eta * eta * wick_left
    sqrt_tail_left = np.concatenate([[0.0], np.sqrt(tail[:-1])])
    tab = np.ascontiguousarray(np.stack([e_tab, sqrt_tail_left]), np.float32)
    scalars = [eta, math.sqrt(dt), dt]
    if spot_leg is not None:
        rho, r, q = (float(x) for x in spot_leg)
        scalars += [rho, math.sqrt(max(1.0 - rho * rho, 0.0)), (r - q) * dt,
                    1.0 / n]
    return np.asarray(scalars, np.float32), cdg, tab


def _lift_state(cdg: np.ndarray, num_paths: int, device):
    """(c, d, g as (m, 1) float32 columns, the zero (m, paths) factor
    state) for the plain versions."""
    cols = [torch.as_tensor(row, device=device)[:, None] for row in cdg]
    return cols, torch.zeros((cdg.shape[1], num_paths), dtype=torch.float32,
                             device=device)


def _lift_mix(tab: np.ndarray, idx: int, z_zeta, c_col, y):
    """w = sqrt(tail_i)·zeta + Σ_j c_j y_j, summed over j in order (the
    kernels' order; the products c_j y_j are elementwise)."""
    prod = c_col * y
    w = float(tab[1, idx]) * z_zeta
    for j in range(prod.shape[0]):
        w = w + prod[j]
    return w


def rbergomi_lift_integrals_plain(eta, T, seed: int, c, d, g, tail,
                                  hurst: float, *, num_paths: int,
                                  num_steps: int, xi_t=None, xi_flat=0.04,
                                  antithetic: bool = True, device="cpu"
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K10 on the kernel's Philox words: call i of
    counter (pair_lo, pair_hi, i, 8) gives Box-Muller(a0, a1) = (z_dW,
    z_zeta) for step 2i and Box-Muller(a2, a3) for step 2i+1; an odd last
    step uses a0, a1 of its own call. One factor state serves both
    branches (the minus branch's is exactly its negation). Each float32
    operation is the kernel's, in its order; I2 is scaled by dt at the end.
    Returns (I1, I2), each (n_branch, num_paths)."""
    device = torch.device(device)
    p, cdg, tab = _rough_tables(eta, xi_flat, hurst, T, num_steps, c, d, g,
                                tail, xi_t)
    eta_f, sqrt_dt, dt = (float(x) for x in p)
    (c_col, d_col, g_col), y = _lift_state(cdg, num_paths, device)
    nb = 2 if antithetic else 1
    zeros = torch.zeros(num_paths, dtype=torch.float32, device=device)
    i1, i2 = [zeros] * nb, [zeros] * nb

    def step(idx, z_dw, z_zeta):
        nonlocal y
        ew = eta_f * _lift_mix(tab, idx, z_zeta, c_col, y)
        e_i = float(tab[0, idx])
        dw = z_dw * sqrt_dt
        for k in range(nb):
            s_ew, s_dw = (ew, dw) if k == 0 else (-ew, -dw)
            v = torch.exp(s_ew + e_i)
            i1[k] = i1[k] + torch.sqrt(v) * s_dw
            i2[k] = i2[k] + v
        y = d_col * y + g_col * dw[None]

    for call in range((num_steps + 1) // 2):
        u = _pair_words(num_paths, call, _ROUGH_DOMAIN, seed, device)
        step(2 * call, *box_muller(u[0], u[1]))
        if 2 * call + 1 < num_steps:
            step(2 * call + 1, *box_muller(u[2], u[3]))
    return torch.stack(i1), torch.stack([x * dt for x in i2])


def rbergomi_lift_integrals(eta, T, seed: int, c, d, g, tail, hurst: float,
                            *, num_paths: int, num_steps: int, xi_t=None,
                            xi_flat=0.04, antithetic: bool = True,
                            device="cuda"
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 wrapper, the counterpart of `rbergomi_lift_integrals_pallas`:
    the Romano-Touzi integrals (I1 = Σ √v dW, I2 = Σ v dt), each
    (n_branch, num_paths), row 0 the base branch, row 1 (antithetic) every
    normal negated, of the m-factor lift with tables `c, d, g, tail` from
    `ops/rough.py:rbergomi_lift` (m ≤ 32); `hurst` must be the one the
    tables were built with. The normals depend on (seed, pair, step) only.
    A CPU `device` takes the plain version; a CUDA one launches the kernel
    or raises."""
    device = _check_prng_args(num_paths, num_steps, seed, device)
    kw = dict(num_paths=num_paths, num_steps=num_steps, xi_t=xi_t,
              xi_flat=xi_flat, antithetic=antithetic)
    if device.type == "cpu":
        return rbergomi_lift_integrals_plain(eta, T, seed, c, d, g, tail,
                                             hurst, device=device, **kw)
    p, cdg, tab = _rough_tables(eta, xi_flat, hurst, T, num_steps, c, d, g,
                                tail, xi_t)
    tab_dev = _device_step_table(tab.tobytes(), num_steps, str(device))
    n_branch = 2 if antithetic else 1
    out = torch.empty((2, n_branch, num_paths), dtype=torch.float32,
                      device=device)
    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.mcos_rbergomi_lift_integrals(
            out[0].data_ptr(), out[1].data_ptr(), tab_dev.data_ptr(),
            num_paths, num_steps, n_branch, int(seed), p.ctypes.data,
            cdg.ctypes.data, int(cdg.shape[1]), _stream_handle(device))
    _check_rc(lib, rc, "rbergomi_lift_integrals")
    with _COUNT_LOCK:
        rbergomi_lift_integrals.launches += 1
    return out[0], out[1]


rbergomi_lift_integrals.launches = 0

_ROUGH_STATS = ("s_terminal", "s_mean", "s_max", "s_min")


def rbergomi_lift_stats_plain(params_vec, T, seed: int, c, d, g, tail,
                              hurst: float, *, num_paths: int,
                              num_steps: int, xi_t=None,
                              antithetic: bool = True, device="cpu"
                              ) -> Dict[str, torch.Tensor]:
    """Plain torch version of K11 on the kernel's Philox words, K7's layout
    in domain 9: steps 2i and 2i+1 take calls 2i and 2i+1 of counter
    (pair_lo, pair_hi, call, 9): words a0..a3, b0, b1 give three Box-Muller
    pairs; step 2i runs on (z_dW, z_zeta, z_perp) = (z_a, z_b, z_c), step
    2i+1 on (z_d, z_e, z_f). An odd last step takes call steps−1 alone:
    (z1, z2) from a0, a1 and z3 from a2, a3. Each float32 operation is the
    kernel's, in its order; the statistics are then scaled by the spot.
    `params_vec` = (eta, rho, r, q, xi, spot). Returns the dict of
    (n_branch, num_paths) s_terminal, s_mean, s_max, s_min over
    t_1..t_n."""
    device = torch.device(device)
    eta, rho, r, q, xi_flat, spot = params_vec
    p, cdg, tab = _rough_tables(eta, xi_flat, hurst, T, num_steps, c, d, g,
                                tail, xi_t, spot_leg=(rho, r, q))
    eta_f, sqrt_dt, dt, rho_f, orth, mu_dt, inv_n = (float(x) for x in p)
    (c_col, d_col, g_col), y = _lift_state(cdg, num_paths, device)
    nb = 2 if antithetic else 1
    zeros = torch.zeros(num_paths, dtype=torch.float32, device=device)
    ls, sum_s = [zeros] * nb, [zeros] * nb
    max_ls = [torch.full_like(zeros, -math.inf)] * nb
    min_ls = [torch.full_like(zeros, math.inf)] * nb

    def step(idx, z_dw, z_zeta, z_perp):
        nonlocal y
        ew = eta_f * _lift_mix(tab, idx, z_zeta, c_col, y)
        e_i = float(tab[0, idx])
        dw = z_dw * sqrt_dt
        dz = (rho_f * z_dw + orth * z_perp) * sqrt_dt
        for k in range(nb):
            s_ew, s_dz = (ew, dz) if k == 0 else (-ew, -dz)
            v = torch.exp(s_ew + e_i)
            drift = mu_dt - (0.5 * v) * dt
            ls[k] = (ls[k] + drift) + torch.sqrt(v) * s_dz
            sum_s[k] = sum_s[k] + torch.exp(ls[k])
            max_ls[k] = torch.maximum(max_ls[k], ls[k])
            min_ls[k] = torch.minimum(min_ls[k], ls[k])
        y = d_col * y + g_col * dw[None]

    def uniforms(call):
        return _pair_words(num_paths, call, _ROUGH_STATS_DOMAIN, seed, device)

    for i in range(0, num_steps - 1, 2):
        a, b = uniforms(i), uniforms(i + 1)
        z_a, z_b = box_muller(a[0], a[1])
        z_c, z_d = box_muller(a[2], a[3])
        z_e, z_f = box_muller(b[0], b[1])
        step(i, z_a, z_b, z_c)
        step(i + 1, z_d, z_e, z_f)
    if num_steps % 2 == 1:
        a = uniforms(num_steps - 1)
        z1, z2 = box_muller(a[0], a[1])
        z3, _ = box_muller(a[2], a[3])
        step(num_steps - 1, z1, z2, z3)
    spot_f = float(np.float32(spot))
    rows = (torch.exp(torch.stack(ls)), torch.stack(sum_s) * inv_n,
            torch.exp(torch.stack(max_ls)), torch.exp(torch.stack(min_ls)))
    return {k: spot_f * x for k, x in zip(_ROUGH_STATS, rows)}


def rbergomi_lift_stats(params_vec, T, seed: int, c, d, g, tail,
                        hurst: float, *, num_paths: int, num_steps: int,
                        xi_t=None, antithetic: bool = True, device="cuda"
                        ) -> Dict[str, torch.Tensor]:
    """K11 wrapper, the counterpart of `rbergomi_lift_stats_pallas`: the
    dict of (n_branch, num_paths) path statistics (s_terminal, s_mean,
    s_max, s_min over t_1..t_n) of the lift plus its spot leg.
    `params_vec` = (eta, rho, r, q, xi, spot); `c, d, g, tail` from
    `ops/rough.py:rbergomi_lift`, `hurst` the tables'. A CPU `device` takes
    the plain version; a CUDA one launches the kernel or raises."""
    device = _check_prng_args(num_paths, num_steps, seed, device)
    if device.type == "cpu":
        return rbergomi_lift_stats_plain(
            params_vec, T, seed, c, d, g, tail, hurst, num_paths=num_paths,
            num_steps=num_steps, xi_t=xi_t, antithetic=antithetic,
            device=device)
    eta, rho, r, q, xi_flat, spot = params_vec
    p, cdg, tab = _rough_tables(eta, xi_flat, hurst, T, num_steps, c, d, g,
                                tail, xi_t, spot_leg=(rho, r, q))
    tab_dev = _device_step_table(tab.tobytes(), num_steps, str(device))
    n_branch = 2 if antithetic else 1
    out = torch.empty((4, n_branch, num_paths), dtype=torch.float32,
                      device=device)
    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.mcos_rbergomi_lift_stats(
            out.data_ptr(), tab_dev.data_ptr(), num_paths, num_steps,
            n_branch, int(seed), p.ctypes.data, cdg.ctypes.data,
            int(cdg.shape[1]), _stream_handle(device))
    _check_rc(lib, rc, "rbergomi_lift_stats")
    with _COUNT_LOCK:
        rbergomi_lift_stats.launches += 1
    spot_f = float(np.float32(spot))
    return {k: spot_f * out[i] for i, k in enumerate(_ROUGH_STATS)}


rbergomi_lift_stats.launches = 0


# ─────────────────────────────────────────────────────────────────────────────
# The viz programs of /api/price: the path recorder and the histogram sampler
# ─────────────────────────────────────────────────────────────────────────────
def _viz_consts(params: SVJParams, spot, T, num_steps: int) -> np.ndarray:
    """The 13 float32 scalars of csrc/svj_viz.cu:VizConsts, each rounded
    as the torch step loop forms it on the card (ops/simulate.py:
    _svj_step_core): dt is float32 T times the float32 reciprocal of the
    step count, which is how torch divides a CUDA tensor by a Python
    number; sums of Python floats are taken in float64, then rounded."""
    f = np.float32
    p = params
    with np.errstate(all="ignore"):
        dt = f(T) * (f(1.0) / f(num_steps))
        k = np.exp(f(p.mu_j + 0.5 * p.sigma_j**2)) - f(1.0)
        return np.array(
            [spot, p.v0, dt, np.sqrt(dt), p.kappa, p.theta, p.xi, p.rho,
             np.sqrt(f(1.0 - p.rho * p.rho)), f(p.lambda_j) * dt, p.mu_j,
             p.sigma_j, f(p.r - p.q) - f(p.lambda_j) * k], dtype=np.float32)


def svj_viz_plain(params: SVJParams, spot, T, z: torch.Tensor,
                  u: torch.Tensor, *, record: bool) -> torch.Tensor:
    """Plain torch version of the viz kernel: the twins' own step loops on
    the draws, `recorded_from_draws` (record) or row 0 of a one-branch
    `simulate_terminal`."""
    if record:
        return recorded_from_draws(params, spot, T, z, u)
    return simulate_terminal(params, spot, T, None, z.shape[2], z.shape[0],
                             antithetic=False, draws=(z, u),
                             device=z.device)[0][0]


def svj_viz(params: SVJParams, spot, T, z: torch.Tensor, u: torch.Tensor,
            *, record: bool) -> torch.Tensor:
    """Viz kernel wrapper: the full-truncation log-Euler SVJ step loop of
    the viz-path recorder (`record=True`) or the histogram sampler, one
    thread a path, in one launch.

    Args:
        params: SVJParams of floats (a tensor leaf raises: the kernel has
            no backward, and the viz programs need none).
        z, u: contiguous float32 draws, (steps, 3, paths) normals (z1, z2,
            z_js) and (steps, paths) jump uniforms, on one device.
    Returns:
        record: (paths, steps + 1) spots, column 0 = spot; else (paths,)
        terminal spots. Each launch counts on `svj_viz.launches` and on
        the span counter `viz_kernel_launches`.
    """
    leaves = [f.name for f in dataclasses.fields(params)
              if isinstance(getattr(params, f.name), torch.Tensor)]
    if leaves:
        raise TypeError(f"svj_viz takes float parameters; {leaves} are "
                        "tensors")
    for name, x in (("z", z), ("u", u)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (z.dim() != 3 or z.shape[1] != 3 or z.numel() == 0
            or tuple(u.shape) != (z.shape[0], z.shape[2])):
        raise ValueError(f"draws must be non-empty (steps, 3, paths) normals "
                         f"and (steps, paths) uniforms, got {tuple(z.shape)} "
                         f"and {tuple(u.shape)}")
    if u.device != z.device:
        raise ValueError(f"u is on {u.device}, z on {z.device}")
    if z.device.type == "cpu":
        return svj_viz_plain(params, spot, T, z, u, record=record)
    if z.device.type != "cuda":
        raise ValueError(f"no kernel for device {z.device}")

    steps, _, num_paths = z.shape
    # Read by the launcher on the host and passed to the kernel by value.
    consts = _viz_consts(params, spot, T, steps)
    out = torch.empty((num_paths, steps + 1) if record else (num_paths,),
                      dtype=torch.float32, device=z.device)
    lib = load_library()
    with torch.cuda.device(z.device):
        rc = lib.mcos_svj_viz(z.data_ptr(), u.data_ptr(), consts.ctypes.data,
                              out.data_ptr(), num_paths, steps, int(record),
                              _stream_handle(z.device))
    _check_rc(lib, rc, "svj_viz")
    with _COUNT_LOCK:
        svj_viz.launches += 1
    spans.count("viz_kernel_launches")
    return out


svj_viz.launches = 0


_WRAPPERS = (svj_terminal_from_draws, gbm_terminal, svj_terminal,
             svj_terminal_qe, svj_terminal_qe_from_draws, svj_path_stats,
             hhw_terminal, svcj_terminal, svj_terminal_td,
             rbergomi_lift_integrals, rbergomi_lift_stats, svj_viz)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    with _COUNT_LOCK:
        for fn in _WRAPPERS:
            fn.launches = 0
        svj_path_stats.variants = {}


def launch_counts() -> dict:
    """{wrapper name: launches since the last reset}."""
    with _COUNT_LOCK:
        return {fn.__name__: fn.launches for fn in _WRAPPERS}
