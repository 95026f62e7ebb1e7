"""Owen-scrambled Sobol net + Brownian bridge in torch
(counterpart of `mcos_tpu/ops/sobol.py`).

The net is bit-identical to the JAX package's:

- Direction numbers come from scipy's Joe-Kuo table, as there.
- The scramble words of `mcos_tpu.ops.sobol._scramble_shift` are
  `jax.random.bits(jax.random.key(seed))`, i.e. threefry2x32 over a
  partitionable iota. `_threefry2x32` below is that hash in numpy, so the
  port reproduces the words without JAX.
- The gray-code XOR expansion and the Burley/Laine-Karras Owen hash run on
  int64 tensors with explicit 32-bit masks (torch has no usable uint32
  shifts or adds), and the hash multiplies wrap mod 2³² through 16-bit
  halves, so no int64 product overflows.
- The inverse CDF is the same Acklam rational approximation, in float32,
  with each Horner step rounded once, as the reference's compiled FMA is.

The Brownian-bridge product is a plain `torch.matmul` in full float32
(TF32 is switched off here: it would move the normals by about 1e-3).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

# Full-precision float32 products for the bridge matmul.
torch.backends.cuda.matmul.allow_tf32 = False

_SOBOL_BITS = 30  # scipy's qmc.Sobol uses 30-bit integers
_U32_SCALE = 2.0 ** -_SOBOL_BITS
_CLIP = 1e-7  # f32-safe tail clip before the inverse CDF
_M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=32)
def sobol_direction_numbers(dims: int) -> np.ndarray:
    """Joe-Kuo direction numbers, shape (dims, 30) uint32, from scipy's table."""
    from scipy.stats import qmc

    return np.array(qmc.Sobol(d=dims, scramble=False)._sv[:, :_SOBOL_BITS],
                    dtype=np.uint32)


# ─────────────────────────────────────────────────────────────────────────────
# Brownian-bridge construction matrix (host numpy, copied unchanged)
# ─────────────────────────────────────────────────────────────────────────────
def bb_ordering(num_steps: int) -> np.ndarray:
    """Bisection order of time points for the bridge (order[0] = terminal)."""
    order = [num_steps]
    queue = [(0, num_steps)]
    while queue:
        lo, hi = queue.pop(0)
        if hi - lo <= 1:
            continue
        mid = (lo + hi) // 2
        order.append(mid)
        queue.append((lo, mid))
        queue.append((mid, hi))
    return np.asarray(order, np.int64)


@functools.lru_cache(maxsize=64)
def brownian_bridge_matrix(num_steps: int) -> np.ndarray:
    """Matrix M with dW = Z @ Mᵀ for unit-horizon Brownian increments.

    Built in float64 on the host once per step count (cached), cast to f32.
    """
    n = num_steps
    order = bb_ordering(n)
    a = np.zeros((n + 1, n), dtype=np.float64)
    t = np.linspace(0.0, 1.0, n + 1)
    placed = [0]  # cumulative index 0 is pinned at W=0
    for dim, k in enumerate(order):
        left = max(p for p in placed if p < k)
        right_candidates = [p for p in placed if p > k]
        if right_candidates:
            right = min(right_candidates)
            w = (t[k] - t[left]) / (t[right] - t[left])
            var = (t[k] - t[left]) * (t[right] - t[k]) / (t[right] - t[left])
            a[k] = (1.0 - w) * a[left] + w * a[right]
        else:
            var = t[k] - t[left]
            a[k] = a[left]
        a[k, dim] += np.sqrt(var)
        placed.append(k)
    m = a[1:] - a[:-1]
    return np.ascontiguousarray(m, dtype=np.float32)


# ─────────────────────────────────────────────────────────────────────────────
# Scramble words: threefry2x32, as jax.random.bits(jax.random.key(seed))
# ─────────────────────────────────────────────────────────────────────────────
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1: int, k2: int, x1: np.ndarray, x2: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) on uint32 arrays."""
    def rotl(v, r):
        return (v << np.uint32(r)) | (v >> np.uint32(32 - r))

    ks = (np.uint32(k1), np.uint32(k2),
          np.uint32(k1 ^ k2 ^ 0x1BD11BDA))
    x = [x1.astype(np.uint32) + ks[0], x2.astype(np.uint32) + ks[1]]
    for i in range(1, 6):
        for r in _THREEFRY_ROTATIONS[(i - 1) % 2]:
            x[0] = x[0] + x[1]
            x[1] = rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[i % 3]
        x[1] = x[1] + ks[(i + 1) % 3] + np.uint32(i)
    return x[0], x[1]


def _seed_key(seed: int) -> Tuple[int, int]:
    """The key words of `jax.random.key(seed)`: (seed >> 32, seed & 2³²−1)."""
    seed = int(seed)
    return (seed >> 32) & _M32, seed & _M32


def _fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """The key words of `jax.random.fold_in(key, data)`: threefry2x32 of the
    counter (0, data) under `key`."""
    a, b = _threefry2x32(key[0], key[1], np.zeros(1, np.uint32),
                         np.full(1, int(data) & _M32, np.uint32))
    return int(a[0]), int(b[0])


def _scramble_shift(seed: int, dims: int) -> np.ndarray:
    """(dims,) uint32 scramble words, bit-equal to the JAX package's
    `_scramble_shift(jax.random.key(seed), dims)`."""
    return _scramble_words(_seed_key(seed), dims)


def _scramble_words(key: Tuple[int, int], dims: int) -> np.ndarray:
    """(dims,) uint32 scramble words of `jax.random.bits(key, (dims,))`
    masked to 30 bits (partitionable threefry: counter = 64-bit iota split
    into (hi, lo) words, output = the two hash words XOR-ed)."""
    k1, k2 = key
    idx = np.arange(dims, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(_M32)).astype(np.uint32)
    b1, b2 = _threefry2x32(k1, k2, hi, lo)
    return (b1 ^ b2) & np.uint32(2**_SOBOL_BITS - 1)


# ─────────────────────────────────────────────────────────────────────────────
# Point generation on int64 tensors holding uint32 values
# ─────────────────────────────────────────────────────────────────────────────
def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x · c mod 2³² for 0 ≤ x < 2³², without overflowing int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    """Bit-reverse each 32-bit word (5 masked swap rounds)."""
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & _M32


def _owen_scramble30(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Hash-based Owen scrambling of 30-bit Sobol integers (Burley 2020):
    reverse bits, Laine-Karras multiply-xor permutation, reverse back."""
    x = (x << 2) & _M32
    x = _reverse_bits32(x)
    x = (x + seed) & _M32
    x = x ^ _mul32(x, 0x6C50B47C)
    x = x ^ _mul32(x, 0xB82F1E52)
    x = x ^ _mul32(x, 0xC7AFE638)
    x = x ^ _mul32(x, 0x8D22F6E6)
    x = _reverse_bits32(x)
    return x >> 2


def _sobol_integers(sv: torch.Tensor, shift: torch.Tensor, num_keep: int,
                    n_bits: int, offset: int = 0) -> torch.Tensor:
    """(dims, num_keep) Owen-scrambled 30-bit Sobol integers of points
    offset..offset+num_keep-1 (int64 holding uint32 values). `n_bits`
    covers the whole net the points belong to, so any slice of it is
    reachable."""
    if int(offset) < 0 or int(offset) + num_keep > 1 << 32:
        raise ValueError(f"points [{offset}, {offset + num_keep}) leave the "
                         "32-bit index range")
    idx = torch.arange(int(offset), int(offset) + num_keep,
                       dtype=torch.int64, device=sv.device)
    gray = idx ^ (idx >> 1)
    acc = torch.zeros((sv.shape[0], num_keep), dtype=torch.int64,
                      device=sv.device)
    for b in range(min(n_bits, _SOBOL_BITS)):
        bit = (gray >> b) & 1
        acc ^= sv[:, b:b + 1] * bit[None, :]
    return _owen_scramble30(acc, shift[:, None])


def _uniforms(acc: torch.Tensor) -> torch.Tensor:
    """Center each 30-bit integer in its cell: float32 uniforms in (0, 1)."""
    return (acc.to(torch.float32) + 0.5) * _U32_SCALE


# Acklam's rational approximation of the inverse normal CDF (the constants
# of mcos_tpu/ops/pallas_kernels.py:_ndtri_kernel).
_ACK_A = (-3.969683028665376e+01, 2.209460984245205e+02,
          -2.759285104469687e+02, 1.383577518672690e+02,
          -3.066479806614716e+01, 2.506628277459239e+00)
_ACK_B = (-5.447609879822406e+01, 1.615858368580409e+02,
          -1.556989798598866e+02, 6.680131188771972e+01,
          -1.328068155288572e+01)
_ACK_C = (-7.784894002430293e-03, -3.223964580411365e-01,
          -2.400758277161838e+00, -2.549732539343734e+00,
          4.374664141464968e+00, 2.938163982698783e+00)
_ACK_D = (7.784695709041462e-03, 3.224671290700398e-01,
          2.445134137142996e+00, 3.754408661907416e+00)
_ACK_PLOW = 0.02425


def _fma(a: torch.Tensor, x: torch.Tensor, c) -> torch.Tensor:
    """float32 a·x + c with one rounding. The product of two float32 values
    is exact in float64, so only the add rounds (then once more to float32).
    XLA contracts the reference's Horner steps into FMAs; rounding the same
    way keeps the normals within float32 noise of it (separate float32
    multiply and add differ by up to 3e-4 near the central/tail seam)."""
    return (a.double() * x.double() + c).float()


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    acc = torch.full_like(x, float(np.float32(coeffs[0])))
    for c in coeffs[1:]:
        acc = _fma(acc, x, float(np.float32(c)))
    return acc


def ndtri_acklam(u: torch.Tensor) -> torch.Tensor:
    """Inverse normal CDF for float32 u strictly inside (0, 1)."""
    qc = u - 0.5
    r = qc * qc
    x_central = _horner(r, _ACK_A) * qc / _fma(_horner(r, _ACK_B), r, 1.0)
    pm = torch.minimum(u, 1.0 - u)
    qt = torch.sqrt(-2.0 * torch.log(pm))
    x_tail = _horner(qt, _ACK_C) / _fma(_horner(qt, _ACK_D), qt, 1.0)
    x_tail = torch.where(qc < 0.0, x_tail, -x_tail)
    central = torch.abs(qc) <= float(np.float32(0.5 - _ACK_PLOW))
    return torch.where(central, x_central, x_tail)


def _normals(sv, shift, num_keep: int, n_bits: int, offset: int = 0):
    u = _uniforms(_sobol_integers(sv, shift, num_keep, n_bits, offset))
    return ndtri_acklam(torch.clamp(u, _CLIP, 1.0 - _CLIP))


def _bb_normals(sv, shift, bb: torch.Tensor, num_keep: int,
                n_bits: int, offset: int = 0) -> torch.Tensor:
    """Brownian-bridge-ordered per-step unit normals, (num_steps, num_keep),
    of points offset..offset+num_keep-1."""
    z = _normals(sv, shift, num_keep, n_bits, offset)
    num_steps = bb.shape[0]
    return torch.matmul(bb, z) * float(np.sqrt(np.float32(num_steps),
                                               dtype=np.float32))


def sobol_normals(num_paths: int, dims: int, seed: int = 0,
                  stream: int = 0, *, device="cuda") -> torch.Tensor:
    """Owen-scrambled Sobol standard normals, (num_paths, dims) float32 on
    `device`: the point count rounds up to a power of two for the bit
    expansion and the first `num_paths` points are kept. `stream`
    decouples the scrambles of independent blocks: its key is
    `jax.random.fold_in(jax.random.key(seed), stream)`, as in the JAX
    package, so the integers are bit-equal to its `sobol_normals`."""
    device = torch.device(device)
    m = int(np.ceil(np.log2(max(num_paths, 2))))
    sv = torch.as_tensor(sobol_direction_numbers(dims).astype(np.int64),
                         device=device)
    shift = torch.as_tensor(
        _scramble_words(_fold_in(_seed_key(seed), stream), dims).astype(
            np.int64), device=device)
    return _normals(sv, shift, num_paths, m).T.contiguous()


def _svj_net(num_keep: int, m: int, offset: int, num_steps: int, seed: int,
             device: torch.device) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Points [offset, offset + num_keep) of the 2^m-point SVJ draw net,
    steps-major (z1, z2, z_js): 3·steps Sobol dimensions split into
    Z1 | Z2 | Z_jump_size, the bridge reordering Z1 and Z2. The whole net
    (`sobol_svj_draws`) and its slices (`sobol_svj_draws_slice`) are both
    made here, so a slice is the whole net's columns bit for bit."""
    s = num_steps
    sv = torch.as_tensor(sobol_direction_numbers(3 * s).astype(np.int64),
                         device=device)
    shift = torch.as_tensor(_scramble_shift(seed, 3 * s).astype(np.int64),
                            device=device)
    bb = torch.as_tensor(brownian_bridge_matrix(s), device=device)
    z1 = _bb_normals(sv[:s], shift[:s], bb, num_keep, m, offset)
    z2 = _bb_normals(sv[s:2 * s], shift[s:2 * s], bb, num_keep, m, offset)
    z_js = _normals(sv[2 * s:], shift[2 * s:], num_keep, m, offset)
    return z1, z2, z_js


def sobol_svj_draws(num_paths: int, num_steps: int, seed: int = 0,
                    layout: str = "steps", jump_uniforms: bool = True,
                    *, device="cuda",
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor], torch.Tensor]:
    """Full SVJ draw set from one scrambled Sobol stream, on `device`.

    3·steps Sobol dimensions split into Z1 | Z2 | Z_jump_size; the bridge
    reorders Z1 and Z2. Point counts round up to a power of two for the
    bit expansion; only the first `num_paths` points are generated (each
    point is independent, so they equal the JAX package's truncated net).

    jump_uniforms=True draws the jump-occurrence uniforms from a
    `torch.Generator` seeded with seed + 1 (a different stream from the
    JAX package's threefry; they carry no QMC structure). The serving path
    passes False: the CUDA kernel then draws them in-kernel.

    Returns (z1, z2, u_jump, z_js) float32, (num_steps, num_paths) for
    layout="steps" or (num_paths, num_steps) for layout="paths".
    """
    if layout not in ("steps", "paths"):
        raise ValueError(f"unknown layout: {layout!r}")
    device = torch.device(device)
    m = int(np.ceil(np.log2(max(num_paths, 2))))
    s = num_steps
    z1, z2, z_js = _svj_net(num_paths, m, 0, s, seed, device)
    u_jump = None
    if jump_uniforms:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) + 1)
        u_jump = torch.rand((s, num_paths), generator=gen, device=device,
                            dtype=torch.float32)
    if layout == "paths":
        return (z1.T.contiguous(), z2.T.contiguous(),
                None if u_jump is None else u_jump.T.contiguous(),
                z_js.T.contiguous())
    return z1, z2, u_jump, z_js


def sobol_svj_draws_slice(paths_slice: int, total_paths: int, offset: int,
                          num_steps: int, seed: int = 0,
                          scramble: str = "owen", *, device="cuda",
                          ) -> Tuple[torch.Tensor, torch.Tensor, None,
                                     torch.Tensor]:
    """Points [offset, offset + paths_slice) of the `total_paths`-point
    SVJ draw net of `sobol_svj_draws` (total_paths a power of two; the
    sharded Sobol driver gives shard i the offset i·paths_slice), on
    `device`.

    The same dimensions, scramble words and Brownian bridge as the whole
    net, so the slices of a mesh put together are the whole net bit for
    bit. No jump uniforms: the caller's kernel draws them (u_jump None).
    Only the Owen scramble is ported. Returns steps-major
    (z1, z2, None, z_js), each (num_steps, paths_slice)."""
    if scramble != "owen":
        raise ValueError(f"only the Owen scramble is ported, not "
                         f"{scramble!r}")
    if total_paths < 2 or total_paths & (total_paths - 1):
        raise ValueError(f"total_paths must be a power of two, got "
                         f"{total_paths}")
    if offset < 0 or offset + paths_slice > total_paths:
        raise ValueError(f"points [{offset}, {offset + paths_slice}) are "
                         f"not in the {total_paths}-point net")
    z1, z2, z_js = _svj_net(paths_slice, int(np.log2(total_paths)), offset,
                            num_steps, seed, torch.device(device))
    return z1, z2, None, z_js


def sobol_qe_draws(num_paths: int, num_steps: int, seed: int = 0,
                   jump_uniforms: bool = True, *, device="cuda",
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor], torch.Tensor]:
    """Draw set of the Andersen QE scheme from one scrambled Sobol stream.

    Dimensions as in the JAX package: 0..s drive the log-spot motion
    (Brownian-bridge reordered, as Euler's z1), s..2s are the
    variance-transition uniforms (no inverse CDF: QE consumes uniforms),
    clipped to [1e-7, 1 − 1e-7]; 2s..3s are jump-size normals. The
    jump-occurrence uniforms come from a `torch.Generator` seeded with
    seed + 1 (jump_uniforms=True), or from the kernel's Philox stream
    (False, the serving path).

    Returns (z_x, u_v, u_jump, z_js) float32, steps-major
    (num_steps, num_paths).
    """
    device = torch.device(device)
    m = int(np.ceil(np.log2(max(num_paths, 2))))
    s = num_steps
    sv = torch.as_tensor(sobol_direction_numbers(3 * s).astype(np.int64),
                         device=device)
    shift = torch.as_tensor(_scramble_shift(seed, 3 * s).astype(np.int64),
                            device=device)
    bb = torch.as_tensor(brownian_bridge_matrix(s), device=device)

    z_x = _bb_normals(sv[:s], shift[:s], bb, num_paths, m)
    u_v = torch.clamp(
        _uniforms(_sobol_integers(sv[s:2 * s], shift[s:2 * s], num_paths, m)),
        _CLIP, 1.0 - _CLIP)
    z_js = _normals(sv[2 * s:], shift[2 * s:], num_paths, m)
    u_jump = None
    if jump_uniforms:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) + 1)
        u_jump = torch.rand((s, num_paths), generator=gen, device=device,
                            dtype=torch.float32)
    return z_x, u_v, u_jump, z_js
