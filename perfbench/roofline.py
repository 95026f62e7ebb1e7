"""The table of peaks and the operation and byte counts of kernel K1
(`csrc/svj_draws.cu`, the SVJ Euler steps over supplied draws).

Frozen copy of `chip_smoke.py`'s `HBM_BYTES_PER_S`, `INSTR_PER_S`,
`K1_MEMBER`, `k1_ops`, K1's entry of `OPS` and `bound`, unchanged, so
that a change to the program's own smoke script cannot move this
yardstick.

Peaks: NVIDIA's H100 SXM data sheet at its 700 W limit: device memory
3.35 TB/s; float32 67 TFLOP/s, i.e. 132 SMs x 128 lanes x 1.98 GHz
instruction slots with an FMA counted as 2 flops. No unit retires more
than those 33.5e12 thread-instructions per second, so a kernel's operation
count over that rate is a lower bound on its time, whatever the mix of
float, integer and special-function instructions.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INSTR_PER_S = 67e12 / 2

# K1 per member path-step, in the algebra it computes: xi dW2 2 (one
# multiply and one FFMA), the jump compare 1; two branches of 6 (sqrt, the
# sum of sqrt(v) z1 1, the sum of v 1, the v update 2 FFMA and its floor
# 1). Per path-step, shared by the launch's P members: the draw loads (3,
# or 4 with streamed jump uniforms), the sum of z1 1, and with in-kernel
# uniforms a quarter Philox call (38) + 4 for the uniform.
K1_MEMBER = 2 + 1 + 2 * 6


def k1_ops(members: int = 1, streamed_u: bool = False) -> float:
    """Operations per member path-step of a P-member K1 launch."""
    shared = (4 if streamed_u else 3 + 38 / 4 + 4) + 1
    return K1_MEMBER + shared / members


OPS = {
    # one member, in-kernel jump uniforms (`/api/price`)
    "svj_terminal_from_draws": k1_ops(1),
}


def bound(name, units: int, in_bytes: int, out_bytes: int) -> dict:
    """The least time the card could take: the larger of the bytes read and
    written over the memory rate and the operations over the instruction
    rate. `name` is a key of OPS, or the operations per unit themselves."""
    ops = OPS[name] if isinstance(name, str) else float(name)
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops * units / INSTR_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops,
            "ops_per_unit": ops, "units": units,
            "bytes": in_bytes + out_bytes}


def k1_least_s(members: int, steps: int, paths: int, n_branch: int,
               companion: bool, streamed_u: bool) -> float:
    """K1's least time at one launch's shape, seconds, as `chip_smoke.py`
    bounds it: every draw read once (three tables, four with streamed jump
    uniforms), every output written once (S, v and G with the companion),
    (members, n_branch, paths) each."""
    draws = (4 if streamed_u else 3) * steps * paths * 4
    outputs = (3 if companion else 2) * members * n_branch * paths * 4
    return bound(k1_ops(members, streamed_u), members * steps * paths,
                 draws, outputs)["bound_ms"] / 1e3
