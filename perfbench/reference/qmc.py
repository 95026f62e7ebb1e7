"""Plain re-derivation of the draws the port's `/api/price` engine prices
from: an Owen-scrambled Sobol net with a Brownian bridge, and the
counter-based Philox jump uniforms.

Written from the algorithms' public definitions, not from the port:

- Sobol integers: scipy's unscrambled Joe-Kuo net (30 bits), read through
  its public API; point i is the XOR of the direction numbers over the
  bits of gray(i).
- The scramble words: Threefry-2x32 (Salmon et al. 2011, 20 rounds) as
  JAX's `random.bits(key(seed), (dims,))` draws them: counter = the 64-bit
  index split into (hi, lo) words, the two output words XOR-ed, masked to
  30 bits.
- The scramble: Burley's hash-based Owen scramble (JCGT 2020): reverse the
  bits, add the seed word, four Laine-Karras multiply-xor rounds, reverse.
- The normals: the exact inverse normal CDF in float64 of the cell-centred
  uniforms, clipped to [1e-7, 1 - 1e-7].
- The bridge: the bisection Brownian bridge, terminal point first, then
  the midpoints of the intervals breadth first.
- The jump uniforms: Philox4x32-10 (Random123) on counter (path lo, path
  hi, step // 4, 0) under key (seed lo, seed hi), word step % 4, mapped to
  ((bits >> 9) + 0.5) * 2^-23.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

BITS = 30
M32 = 0xFFFFFFFF
CLIP = 1e-7


# ── Threefry-2x32 ───────────────────────────────────────────────────────────
def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32, 20 rounds, on uint32 arrays under a 2-word key."""
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    k = [np.uint32(key[0]), np.uint32(key[1]),
         np.uint32(key[0] ^ key[1] ^ 0x1BD11BDA)]
    a = x0.astype(np.uint32) + k[0]
    b = x1.astype(np.uint32) + k[1]
    for block in range(5):
        for r in rot[block % 2]:
            a = a + b
            b = ((b << np.uint32(r)) | (b >> np.uint32(32 - r))) ^ a
        a = a + k[(block + 1) % 3]
        b = b + k[(block + 2) % 3] + np.uint32(block + 1)
    return a, b


def scramble_words(seed: int, dims: int) -> np.ndarray:
    """(dims,) 30-bit words of `random.bits(key(seed), (dims,))`."""
    key = ((int(seed) >> 32) & M32, int(seed) & M32)
    idx = np.arange(dims, dtype=np.uint64)
    with np.errstate(over="ignore"):
        a, b = threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                            (idx & np.uint64(M32)).astype(np.uint32))
    return (a ^ b) & np.uint32((1 << BITS) - 1)


# ── Sobol integers ──────────────────────────────────────────────────────────
@functools.lru_cache(maxsize=8)
def direction_numbers(dims: int, n_bits: int) -> np.ndarray:
    """(dims, n_bits) direction numbers: point 2^(b+1) - 1 of the
    unscrambled net has gray code 2^b, so it is direction number b."""
    from scipy.stats import qmc

    out = np.empty((dims, n_bits), np.int64)
    for b in range(n_bits):
        eng = qmc.Sobol(d=dims, scramble=False, bits=BITS)
        eng.fast_forward((1 << (b + 1)) - 1)
        out[:, b] = np.rint(eng.random(1)[0] * (1 << BITS)).astype(np.int64)
    return out


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for 0 <= x < 2^32 on int64, in 16-bit halves of c."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def _reverse32(x: torch.Tensor) -> torch.Tensor:
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                        (8, 0x00FF00FF)):
        x = ((x >> shift) & mask) | ((x & mask) << shift)
    return ((x >> 16) | (x << 16)) & M32


def owen_scramble(x: torch.Tensor, seed_word: torch.Tensor) -> torch.Tensor:
    """Burley's Owen scramble of 30-bit integers (int64 holding uint32)."""
    x = _reverse32((x << 2) & M32)
    x = (x + seed_word) & M32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, c)
    return _reverse32(x) >> 2


def sobol_normals(num_points: int, dims: int, seed: int, device,
                  dtype=torch.float64) -> torch.Tensor:
    """(dims, num_points) scrambled-Sobol standard normals: the first
    `num_points` points of the 2^m-point net, m = ceil(log2(num_points))."""
    m = max(1, math.ceil(math.log2(max(num_points, 2))))
    n_bits = min(m, BITS)
    v = torch.as_tensor(direction_numbers(dims, n_bits), device=device)
    idx = torch.arange(num_points, dtype=torch.int64, device=device)
    gray = idx ^ (idx >> 1)
    acc = torch.zeros((dims, num_points), dtype=torch.int64, device=device)
    for b in range(n_bits):
        acc ^= v[:, b:b + 1] * ((gray >> b) & 1)[None, :]
    words = torch.as_tensor(scramble_words(seed, dims).astype(np.int64),
                            device=device)[:, None]
    u = (owen_scramble(acc, words).to(torch.float64) + 0.5) * 2.0 ** -BITS
    return torch.special.ndtri(torch.clamp(u, CLIP, 1.0 - CLIP)).to(dtype)


def brownian_bridge(z: torch.Tensor) -> torch.Tensor:
    """(steps, N) per-step standard normals from (steps, N) normals placed by
    the bisection bridge on [0, 1]: z[0] fixes W(1), then each interval's
    midpoint breadth first."""
    n = z.shape[0]
    t = [k / n for k in range(n + 1)]
    w = [None] * (n + 1)
    w[0] = torch.zeros_like(z[0])
    w[n] = z[0]
    dim, queue = 1, [(0, n)]
    while queue:
        lo, hi = queue.pop(0)
        if hi - lo <= 1:
            continue
        mid = (lo + hi) // 2
        frac = (t[mid] - t[lo]) / (t[hi] - t[lo])
        var = (t[mid] - t[lo]) * (t[hi] - t[mid]) / (t[hi] - t[lo])
        w[mid] = (1 - frac) * w[lo] + frac * w[hi] + math.sqrt(var) * z[dim]
        dim += 1
        queue += [(lo, mid), (mid, hi)]
    return (torch.stack(w[1:]) - torch.stack(w[:-1])) * math.sqrt(n)


def svj_sobol_draws(num_paths: int, steps: int, seed: int, device,
                    dtype=torch.float64):
    """(z1, z2, z_jump_size), each (steps, num_paths): dimensions
    [0, s) and [s, 2s) through the bridge, [2s, 3s) as they are."""
    z = sobol_normals(num_paths, 3 * steps, seed, device, torch.float64)
    z1 = brownian_bridge(z[:steps])
    z2 = brownian_bridge(z[steps:2 * steps])
    return z1.to(dtype), z2.to(dtype), z[2 * steps:].to(dtype)


# ── Philox4x32-10 ───────────────────────────────────────────────────────────
def philox4x32_10(counter, key):
    """Philox4x32-10 of uint64 arrays holding 32-bit counter words."""
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    w0, w1 = 0x9E3779B9, 0xBB67AE85
    mask = np.uint64(M32)
    c0, c1, c2, c3 = (np.asarray(c, np.uint64) for c in counter)
    k0, k1 = int(key[0]), int(key[1])
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + w0) & M32, (k1 + w1) & M32
        p0, p1 = m0 * c0, m1 * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ np.uint64(k0),
                          p1 & mask,
                          (p0 >> np.uint64(32)) ^ c3 ^ np.uint64(k1),
                          p0 & mask)
    return c0, c1, c2, c3


def jump_uniforms(steps: int, num_paths: int, seed: int) -> np.ndarray:
    """(steps, num_paths) float64 jump uniforms of the in-kernel stream."""
    path = np.arange(num_paths, dtype=np.uint64)
    key = (int(seed) & M32, (int(seed) >> 32) & M32)
    rows = []
    for quad in range((steps + 3) // 4):
        words = philox4x32_10(
            (path & np.uint64(M32), path >> np.uint64(32),
             np.full_like(path, quad), np.zeros_like(path)), key)
        rows += [((w >> np.uint64(9)).astype(np.float64) + 0.5) * 2.0 ** -23
                 for w in words]
    return np.stack(rows[:steps])
