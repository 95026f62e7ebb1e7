"""The parsers and the occupancy arithmetic of `mcos_tpu_torch/kernel_lab.py`
on canned compiler output: what ptxas reports, how SASS opcodes are
classed, which instructions of a loop are hot, how many pair-steps a K6,
K8, K10 or K11 loop pass covers, and how many blocks an SM holds. Needs no
card and no nvcc."""

import pytest
import torch

from mcos_tpu_torch import kernel_lab as kl

torch.set_num_threads(1)

_K11 = ("_ZN50_GLOBAL__N__c93de0e1_17_rbergomi_stats_cu_28ef36cd21"
        "rbergomi_stats_kernelILi2ELi25ELb1EEEvPfPKfxiN4mcos10PhiloxKeysE"
        "NS_11StatsConstsE")
_K10 = ("_ZN49_GLOBAL__N__77330fa8_16_rbergomi_lift_cu_5d284c0820"
        "rbergomi_lift_kernelILi1ELi24ELb1EEEvPfS1_PKfxiN4mcos10PhiloxKeysE"
        "NS_10LiftConstsE")
_K6 = ("_ZN45_GLOBAL__N__d5b3d7e3_12_svj_stats_cu_f6a9ad8f16svj_stats_kernel"
       "ILi2ELi3ELb1EEEvPfxiiiNSt11conditionalIL_ZNS_10kRoundKeysEEN4mcos10"
       "PhiloxKeysE5uint2E4typeENS_11StatsConstsE")
_K8 = ("_ZN39_GLOBAL__N__9ce7a76a_7_svcj_cu_0619f52e11svcj_kernelILi2EEEvPf"
       "S1_S1_xi5uint2NS_10SvcjConstsE")
_K5 = ("_ZN48_GLOBAL__N__a44d9fff_15_svj_qe_draws_cu_e7b387e219svj_qe_draws_"
       "kernelILi2ELb1ENS_11LoadedDrawsEEEvT1_PKfPfS5_S5_xiN4mcos10PhiloxKeys"
       "EN4mcos8QeConstsE")
_K7 = ("_ZN38_GLOBAL__N__4ece8f2d_6_hhw_cu_8111799510hhw_kernelILi2EEEvPfS1_xi"
       "N4mcos10PhiloxKeysENS_9HhwConstsE")
# K4's kernel, whose name K5's pattern must not match
_K4 = ("_ZN42_GLOBAL__N__0d6f3c1a_9_svj_qe_cu_5b6e2a1913svj_qe_kernelILi2EEEvPf"
       "S1_S1_PKdixi5uint2N4mcos8QeConstsE")
# K3 and K4 with round keys, K1, K2 and K9: with the names above, the
# eleven kernels' instantiations
_K3 = ("_ZN38_GLOBAL__N__4c9901ee_6_svj_cu_d24bd5f210svj_kernelILi2EEEvPfS1_"
       "S1_PKdixiN4mcos10PhiloxKeysENS_13SvjPrngConstsE")
_K4_KEYS = ("_ZN41_GLOBAL__N__1adea571_9_svj_qe_cu_385c63d113svj_qe_kernelILi1E"
            "EEvPfS1_S1_PKdixiN4mcos10PhiloxKeysENS1_8QeConstsE")
_K1 = ("_ZN44_GLOBAL__N__3e1f0b2a_12_svj_draws_cu_7c4d9a1e16svj_draws_kernel"
       "EPKfS1_S1_S1_PfS2_S2_xii5uint2NS_9SvjConstsE")
# K1 over a population (csrc/svj_draws.cu, three members a thread).
_K1_POP = ("_ZN45_GLOBAL__N__0c02a65f_12_svj_draws_cu_70314c3216svj_draws_"
           "kernelILi3EEEvPKfS2_S2_S2_S2_PfxiiiiiN4mcos10PhiloxKeysE")
_K2 = ("_ZN38_GLOBAL__N__eca620af_6_gbm_cu_21a6af4110gbm_kernelEPfxiiN4mcos"
       "10PhiloxKeysEfff")
_K9 = ("_ZN41_GLOBAL__N__ed5980cf_9_svj_td_cu_322ca70213svj_td_kernelILi2EEEv"
       "PfS1_S1_PKfPKdixiN4mcos10PhiloxKeysENS_8TdConstsE")

# What `nvcc -Xptxas -v` prints for one file: an entry function with a
# stack frame, an internal function whose frame must not be charged to it,
# and a second entry function with spills.
_PTXAS = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{_K11}' for 'sm_90a'
ptxas info    : Function properties for {_K11}
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 75 registers, used 0 barriers, 32 bytes cumulative stack size, 928 bytes cmem[0]
ptxas info    : Function properties for __internal_trig_reduction_slowpathd
    40 bytes stack frame, 40 bytes spill stores, 40 bytes spill loads
ptxas info    : Compiling entry function '{_K10}' for 'sm_90a'
ptxas info    : Function properties for {_K10}
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 8 bytes cumulative stack size, 872 bytes cmem[0]
"""


def test_ptxas_resources_reads_registers_stack_and_spills():
    res = kl.ptxas_resources(_PTXAS)
    assert res == {
        _K11: {"stack": 32, "spill_stores": 0, "spill_loads": 0,
               "registers": 75},
        _K10: {"stack": 8, "spill_stores": 12, "spill_loads": 16,
               "registers": 64},
    }


@pytest.mark.parametrize("op, cls", [
    ("FFMA", "FFMA"), ("FADD.FTZ", "FADD"), ("FMUL", "FMUL"),
    ("IMAD.WIDE.U32", "IMAD.WIDE"), ("IMAD.HI.U32", "IMAD.HI"),
    ("IMAD.MOV.U32", "IMAD"), ("I2FP.F32.U32", "I2F"), ("F2I.NTZ", "F2I"),
    ("MUFU.EX2", "MUFU.EX2"), ("MUFU.RSQ", "MUFU.RSQ"),
    ("LDG.E.CONSTANT", "LDG"), ("ULDC.64", "ULDC"), ("UIADD3", "uniform"),
    ("BSSY", "BSSY"), ("CALL.REL.NOINC", "CALL"), ("FMNMX", "FMNMX"),
    ("LOP3.LUT", "LOP3"), ("HFMA2.MMA", "other"), ("DSETP.GT.AND", "other"),
    ("DFMA", "DFMA"), ("DADD", "DADD"), ("DMUL", "DMUL"),
    ("F2F.F64.F32", "F2F.F64.F32"), ("F2F.F32.F64", "F2F.F32.F64"),
    ("F2F.F16.F32", "F2F"),
])
def test_op_class(op, cls):
    assert kl._op_class(op) == cls


# A loop from 0x10 to 0xc0: a trig argument test and the Payne-Hanek path
# it jumps over (0x40-0x60), a sqrt's special-input call that a branch
# skips (0x90), two exps, and the backward branch. Code before and after
# lies outside it.
_LISTING = [
    (0x000, "MOV", "MOV R1, c[0x0][0x28]"),
    (0x010, "FMUL", "FMUL R2, R2, R3"),
    (0x020, "FSETP.GEU.AND", "FSETP.GEU.AND P0, PT, |R2|, 105615, PT"),
    (0x030, "BRA", "@!P0 BRA 0x70"),
    (0x040, "IMAD.WIDE.U32", "IMAD.WIDE.U32 R4, R2, R5, RZ"),
    (0x050, "LOP3.LUT", "LOP3.LUT R4, R4, R5, RZ, 0x3c, !PT"),
    (0x060, "IADD3", "IADD3 R5, R4, 0x1, RZ"),
    (0x070, "MUFU.RSQ", "MUFU.RSQ R6, R2"),
    (0x080, "BRA", "@P1 BRA 0xa0"),
    (0x090, "CALL.REL.NOINC", "CALL.REL.NOINC 0x200"),
    (0x0a0, "MUFU.EX2", "MUFU.EX2 R7, R6"),
    (0x0b0, "MUFU.EX2", "MUFU.EX2 R8, R7"),
    (0x0c0, "BRA", "@P2 BRA 0x10"),
    (0x0d0, "EXIT", "EXIT"),
]


def test_cold_leaves_out_the_slow_paths_a_branch_jumps_over():
    body = [x for x in _LISTING if 0x10 <= x[0] <= 0xC0]
    assert kl._cold(body) == {0x40, 0x50, 0x60, 0x90}


def test_loop_counts_on_a_synthetic_listing():
    (loop,) = kl.loop_counts(_LISTING)
    assert (loop["start"], loop["end"]) == (0x10, 0xC0)
    assert loop["instructions"] == 12
    assert loop["hot_instructions"] == 8
    assert loop["exits_to_slow_paths"] == 1      # the call to 0x200
    assert loop["by_class"]["IMAD.WIDE"] == 1
    assert "IMAD.WIDE" not in loop["hot_by_class"]
    assert "CALL" not in loop["hot_by_class"]
    assert loop["hot_by_class"] == {"BRA": 3, "FMUL": 1, "FSETP": 1,
                                    "MUFU.EX2": 2, "MUFU.RSQ": 1}


def test_exps_per_pair_step_from_the_mangled_name():
    assert kl.exps_per_pair_step(_K11) == 4       # two branches, two exps
    assert kl.exps_per_pair_step(_K10) == 1       # one branch, one exp
    assert kl.exps_per_pair_step("gbm_kernel") is None


def test_sass_report_counts_per_pair_step(monkeypatch):
    """A K10 loop of two exps at one branch covers two pair-steps; a K11
    loop of the same two exps at two branches covers half of one. The
    listing is padded to the report's 20-instruction floor."""
    pad = [(0x0d0 + 0x10 * i, "NOP", "NOP") for i in range(12)]
    body = _LISTING[:-2] + pad
    end = body[-1][0] + 0x10
    body = body + [(end, "BRA", "@P2 BRA 0x10"), (end + 0x10, "EXIT", "EXIT")]
    monkeypatch.setattr(kl, "sass_functions",
                        lambda path: {_K10: body, _K11: body,
                                      "other_kernel": body})
    rep = kl.sass_report("unused.so", r"rbergomi_lift_kernel|"
                         r"rbergomi_stats_kernel")
    assert set(rep) == {_K10, _K11}
    (k10,) = rep[_K10]["loops"]
    (k11,) = rep[_K11]["loops"]
    assert k10["hot_instructions"] == k11["hot_instructions"] == 20
    assert k10["pair_steps"] == 2 and k10["hot_per_pair_step"] == 10
    assert k11["pair_steps"] == 0.5 and k11["hot_per_pair_step"] == 40


def test_the_lab_knows_k6_and_k8():
    assert kl._KERNELS["k6"] == "svj_stats.cu"
    assert kl._KERNELS["k8"] == "svcj.cu"
    assert kl.TIMED_PAIRS["k6"] == kl.TIMED_PAIRS["k8"] == 200_000
    # each kernel's pattern finds its own instantiations and no other's
    names = {"k6": _K6, "k8": _K8, "k10": _K10, "k11": _K11}
    for short, name in names.items():
        hits = [k for k, pat in kl._SASS_PATTERN.items() if pat in name]
        assert hits == [short], (short, hits)
    # chip_smoke.py's five K6 variants, and the checks' two more
    assert [v[0] for v in kl.K6_VARIANTS] == [
        "asian", "up", "corridor", "corridor_window", "corridor_252"]
    assert {v[0] for v in kl.K6_CHECKS} - {v[0] for v in kl.K6_VARIANTS} == {
        "down_window", "corridor_v0_zero"}
    assert {lam for *_, lam in kl.K8_CHECKS} == {0.0, 1.0, 8.0}


def _philox_call(at: int, products: int):
    """A Philox call's products as ptxas writes them: IMAD.WIDE.U32 by the
    two multipliers, one of them split into IMAD.HI and a low IMAD (which
    is not a second product), with the xors between."""
    out = []
    for i in range(products):
        mult = ("-0x2daee0ad", "-0x326172a9")[i % 2]
        if i == 0:
            out += [(at, "IMAD.HI.U32", f"IMAD.HI.U32 R9, R12, {mult}, RZ"),
                    (at + 0x10, "IMAD", f"IMAD R8, R12, {mult}, RZ")]
            at += 0x20
        else:
            out.append((at, "IMAD.WIDE.U32",
                        f"IMAD.WIDE.U32 R2, R3, {mult}, RZ"))
            at += 0x10
        out.append((at, "LOP3.LUT", "LOP3.LUT R2, R3, UR4, R2, 0x96, !PT"))
        at += 0x10
    return out, at


def _k_listing(calls, products=17, jump_call=False):
    """A loop pass of `calls` Philox calls (plus a third behind a
    conditional branch with `jump_call`, as K8 draws its jump sizes), an
    unrelated wide multiply by a register, and the backward branch."""
    body, at = [], 0x100
    for _ in range(calls):
        ins, at = _philox_call(at, products)
        body += ins
    body.append((at, "IMAD.WIDE.U32", "IMAD.WIDE.U32 R4, R5, R6, RZ"))
    at += 0x10
    if jump_call:
        ins, end = _philox_call(at + 0x10, products)
        body.append((at, "BRA", f"@!P3 BRA {hex(end)}"))
        body += ins
        at = end
    body += [(at, "FADD", "FADD R1, R1, R2"),
             (at + 0x10, "BRA", "@P0 BRA 0x100"),
             (at + 0x20, "EXIT", "EXIT")]
    return body


@pytest.mark.parametrize("products, calls", [(17, 1), (18, 1), (34, 2),
                                             (36, 2), (49, 3), (54, 3),
                                             (68, 4), (72, 4)])
def test_philox_calls_from_products(products, calls):
    assert kl.philox_calls(products) == calls


def test_philox_products_count_each_product_once():
    ins, _ = _philox_call(0x100, 17)
    assert kl.philox_products(ins) == 17
    assert kl.philox_products(
        [(0, "IMAD.WIDE.U32", "IMAD.WIDE.U32 R4, R5, R6, RZ"),
         (0x10, "IMAD.WIDE", "IMAD.WIDE R8, R3, -0x2daee0ad, R8")]) == 0


@pytest.mark.parametrize("name, calls, steps", [
    (_K6, 1, 1), (_K6, 2, 2), (_K8, 2, 2), (_K8, 3, 2), (_K8, 4, 4),
    (_K8, 6, 4), (_K10, 2, None), ("gbm_kernel", 2, None), (_K7, 2, 2),
    (_K7, 4, 4), (_K5, 1, None)])
def test_pair_steps_from_calls(name, calls, steps):
    assert kl.pair_steps_from_calls(name, calls) == steps


def test_sass_report_reads_k6_and_k8_pair_steps(monkeypatch):
    """A K6 pass of two calls covers two pair-steps. A K8 pass of two calls
    and a third behind a branch (the jump draws) covers two as well; where
    that branch skips, the pass is the two calls alone."""
    k6 = _k_listing(2)
    k8 = _k_listing(2, jump_call=True)
    monkeypatch.setattr(kl, "sass_functions",
                        lambda path: {_K6: k6, _K8: k8})
    rep = kl.sass_report("unused.so", r"svj_stats_kernel|svcj_kernel")
    (l6,) = rep[_K6]["loops"]
    (l8,) = rep[_K8]["loops"]
    assert (l6["philox_products"], l6["pair_steps"]) == (34, 2)
    assert l6["hot_per_pair_step"] == l6["hot_instructions"] / 2
    assert l6["hot_if_branches_skip"] == l6["hot_instructions"]
    assert (l8["philox_products"], l8["pair_steps"]) == (51, 2)
    jump = 17 * 2 + 1                  # the third call's products and xors
    assert l8["forward_branches"][0]["skips"] == jump
    assert l8["hot_if_branches_skip"] == l8["hot_instructions"] - jump
    assert l8["hot_if_branches_skip_per_pair_step"] == (
        l8["hot_if_branches_skip"] / 2)


def test_cold_leaves_out_the_corridor_fallback_divides():
    """Nine library divides (an FCHK each) behind one branch and no exp
    are K6's corridor fallback: cold. The same span with an exp in it, or
    with fewer divides, is live code (a window's increment, say)."""
    def listing(divides, with_exp):
        body = [(0x10, "FMUL", "FMUL R2, R2, R3"),
                (0x20, "BRA", "@!P4 BRA 0x400")]
        at = 0x30
        for _ in range(divides):
            body += [(at, "MUFU.RCP", "MUFU.RCP R5, R7"),
                     (at + 0x10, "FCHK", "FCHK P0, R0, R7")]
            at += 0x20
        if with_exp:
            body.append((at, "MUFU.EX2", "MUFU.EX2 R6, R6"))
        body += [(0x400, "FADD", "FADD R1, R1, R2"),
                 (0x410, "BRA", "@P2 BRA 0x10")]
        return body
    cold = kl._cold(listing(9, False))
    assert len(cold) == 18 and 0x400 not in cold
    assert kl._cold(listing(9, True)) == set()
    assert kl._cold(listing(8, False)) == set()


@pytest.mark.parametrize("registers, blocks, per_sm, waves", [
    (39, 782, 6, 782 / 792),    # K9 at 200 000 pairs: one wave
    (56, 782, 4, 782 / 528),    # K6's Asian at 200 000 pairs: 1.48 waves
    (80, 782, 3, 782 / 396),    # K6's corridor + companion: 1.97 waves
    (40, 782, 6, 782 / 792),    # K8: one wave
    (75, 512, 3, 512 / 396),    # K11 at 75 registers: 1.29 waves
    (64, 512, 4, 512 / 528),    # K10: one wave
    (44, 1954, 5, 1954 / 660),  # K5's two-region design at 500 000 paths
    (40, 1954, 6, 1954 / 792),  # K5's redesign: 2.47 waves
    (38, 782, 6, 782 / 792),    # K7 at 200 000 pairs: one wave
    (65, 512, 3, 512 / 396),    # a register more: units of 8 a thread
    (32, 512, 8, 512 / 1056),   # the 64-warp cap of an SM
])
def test_occupancy_at_known_points(registers, blocks, per_sm, waves):
    occ = kl.occupancy(registers, 256, blocks)
    assert occ["blocks_per_sm"] == per_sm
    assert occ["slots"] == per_sm * 132
    assert occ["waves"] == pytest.approx(waves)
    assert (occ["waves"] <= 1) == (blocks <= per_sm * 132)


def test_occupancy_of_smaller_blocks():
    # 75 registers: 25 warps an SM, so 6 blocks of 128 or 25 blocks of 32.
    assert kl.occupancy(75, 128)["blocks_per_sm"] == 6
    assert kl.occupancy(75, 32)["blocks_per_sm"] == 25
    assert kl.occupancy(16, 32)["blocks_per_sm"] == 32   # the block cap


@pytest.mark.parametrize("name, short", [
    (_K11, "rbergomi_stats_kernelILi2ELi25ELb1EE"),
    (_K6, "svj_stats_kernelILi2ELi3ELb1EE"),
    (_K8, "svcj_kernelILi2EE"),
    (_K10, "rbergomi_lift_kernelILi1ELi24ELb1EE"),
    (_K5, "svj_qe_draws_kernelILi2ELb1EE"),
    (_K7, "hhw_kernelILi2EE"),
    ("_ZN38_GLOBAL__N__eca620af_6_gbm_cu_21a6af4110gbm_kernelEPfxiiN4mcos"
     "10PhiloxKeysEfff", "gbm_kernel"),
    ("_ZN41_GLOBAL__N__ed5980cf_9_svj_td_cu_322ca70213svj_td_kernelILi2EEEv"
     "PfS1_S1_PKfPKdixiN4mcos10PhiloxKeysENS_8TdConstsE",
     "svj_td_kernelILi2EE"),
])
def test_short_name_keeps_one_file_per_instantiation(name, short):
    assert kl._short_name(name) == short


def test_the_lab_knows_k5_and_k7():
    assert kl._KERNELS["k5"] == "svj_qe_draws.cu"
    assert kl._KERNELS["k7"] == "hhw.cu"
    assert kl.TIMED_PAIRS["k5"] == 500_000 and kl.TIMED_PAIRS["k7"] == 200_000
    names = {"k5": _K5, "k7": _K7, "k6": _K6, "k8": _K8, "k10": _K10,
             "k11": _K11}
    for short, name in names.items():
        hits = [k for k, pat in kl._SASS_PATTERN.items() if pat in name]
        assert hits == [short], (short, hits)
    assert [k for k, pat in kl._SASS_PATTERN.items() if pat in _K4] == ["k4"]
    # chip_smoke.py's K5 shape and the two cases where psi crosses 1.5
    assert [c[:3] for c in kl.K5_CHECKS] == [
        ("route", 500_000, 63), ("psi_4", 500_000, 4), ("psi_8", 500_000, 8)]
    assert set(kl.K7_CHECKS) == {(s, nb) for s in (128, 127, 1)
                                 for nb in (1, 2)}


def _k5_listing(steps: int, own_jumps: bool):
    """A K5 loop pass of `steps` steps: three draw loads each; with
    `own_jumps` one Philox call behind a conditional branch (drawn every
    fourth step) and the jump uniform's load predicated off, else a fourth
    load a step; padded to the report's 20-instruction floor."""
    body = [(0x100 + 0x10 * i, "NOP", "NOP") for i in range(20)]
    at = 0x100 + 0x10 * 20
    for _ in range(steps):
        for r in range(3 if own_jumps else 4):
            body.append((at, "LDG.E.CONSTANT",
                         f"LDG.E.CONSTANT R{r}, desc[UR6][R22.64]"))
            at += 0x10
    if own_jumps:
        body.append((at, "LDG.E.CONSTANT",
                     "@P0 LDG.E.CONSTANT R9, desc[UR6][R22.64]"))
        ins, end = _philox_call(at + 0x20, 17)
        body.append((at + 0x10, "BRA", f"@!P3 BRA {hex(end)}"))
        body += ins
        at = end
    body += [(at, "FADD", "FADD R1, R1, R2"),
             (at + 0x10, "BRA", "@P0 BRA 0x100"),
             (at + 0x20, "EXIT", "EXIT")]
    return body


@pytest.mark.parametrize("steps, own_jumps", [(1, True), (4, True),
                                              (1, False), (2, False)])
def test_sass_report_reads_k5_steps_from_its_loads(monkeypatch, steps,
                                                   own_jumps):
    """K5's steps a pass are its unconditional draw loads over three (the
    jump uniforms drawn in the kernel: the loop holds Philox products) or
    four (loaded); a predicated load, or one a branch jumps over, is not
    counted."""
    body = _k5_listing(steps, own_jumps)
    monkeypatch.setattr(kl, "sass_functions", lambda path: {_K5: body})
    (loop,) = kl.sass_report("unused.so", "svj_qe_draws_kernel")[_K5][
        "loops"]
    assert loop["unconditional_loads"] == steps * (3 if own_jumps else 4)
    assert loop["pair_steps"] == steps
    assert loop["hot_per_pair_step"] == loop["hot_instructions"] / steps


def test_sass_report_counts_k7_pair_steps_and_double_ops(monkeypatch):
    """A K7 pass of two Philox calls covers two pair-steps; DFMA and the
    two directions of F2F are classed on their own."""
    body = _k_listing(2)
    extra = [(0x104, "F2F.F64.F32", "F2F.F64.F32 R22, R22"),
             (0x108, "DFMA", "DFMA R38, R22, -UR24, R24"),
             (0x10c, "F2F.F32.F64", "F2F.F32.F64 R26, R38")]
    body = [body[0]] + extra + body[1:]
    monkeypatch.setattr(kl, "sass_functions", lambda path: {_K7: body})
    (loop,) = kl.sass_report("unused.so", "hhw_kernel")[_K7]["loops"]
    assert loop["pair_steps"] == 2
    assert {k: loop["hot_by_class"][k] for k in (
        "DFMA", "F2F.F64.F32", "F2F.F32.F64")} == {
        "DFMA": 1, "F2F.F64.F32": 1, "F2F.F32.F64": 1}


def test_lever_versions_make_one_edit_each(monkeypatch, tmp_path):
    """Each lever of the K5 and K7 designs is found once in the package's
    sources, and its variant differs from them in that file alone."""
    import os

    monkeypatch.setattr(kl, "_LAB_DIR", str(tmp_path))
    versions = kl.lever_versions(kl.ck.CSRC_DIR, ("k5", "k7"))
    assert set(versions) == {lv[0] for k in ("k5", "k7")
                             for lv in kl._LEVERS[k]}
    for name, work in versions.items():
        (source,) = [lv[1] for k in ("k5", "k7") for lv in kl._LEVERS[k]
                     if lv[0] == name]
        changed = []
        for f_name in os.listdir(kl.ck.CSRC_DIR):
            with open(os.path.join(kl.ck.CSRC_DIR, f_name)) as a, open(
                    os.path.join(work, f_name)) as b:
                if a.read() != b.read():
                    changed.append(f_name)
        assert changed == [source], name


def test_the_eager_qe_transition_lives_in_the_lab_alone(monkeypatch,
                                                        tmp_path):
    """No kernel runs the eager QE transition, so `philox.cuh` does not
    hold it: the lab's own copy serves K5's `k5_eager_qe` lever (defined
    after the include, then called in place of `qe_step_lazy`) and the
    compute floor of K5's two-region design."""
    import os

    with open(os.path.join(kl.ck.CSRC_DIR, "philox.cuh")) as f:
        assert "float qe_variance_step(" not in f.read()
    assert kl._QE_EAGER_SRC in kl._K5_LAB_SRC
    assert "lab::qe_eager(v, mcos::acklam_ndtri(u_v), u_v, c)" in \
        kl._K5_LAB_SRC
    monkeypatch.setattr(kl, "_LAB_DIR", str(tmp_path))
    work = kl.lever_versions(kl.ck.CSRC_DIR, ("k5",))["k5_eager_qe"]
    with open(os.path.join(work, "svj_qe_draws.cu")) as f:
        text = f.read()
    assert text.count(kl._QE_EAGER_SRC) == 1
    assert text.index('#include "philox.cuh"') < text.index(
        kl._QE_EAGER_SRC) < text.index("lab::qe_eager(v, acklam_converged(")
    assert "= qe_step_lazy(v, u_v, c);" not in text


def test_k5_lab_source_follows_the_version(tmp_path):
    """The K5 lab file runs a version's own kernel in the compute floor
    and its own Acklam form in the probe only where the version has them
    (the two-region design has neither)."""
    assert kl._k5_lab_source(kl.ck.CSRC_DIR).startswith(
        "#define K5_HAS_LAUNCH\n#define K5_HAS_ACKLAM\n")
    (tmp_path / "svj_qe_draws.cu").write_text("// qe_variance_step only\n")
    assert kl._k5_lab_source(str(tmp_path)) == kl._K5_LAB_SRC


def test_the_lab_knows_k3_and_k4():
    assert kl._KERNELS["k3"] == "svj.cu"
    assert kl._KERNELS["k4"] == "svj_qe.cu"
    assert kl.TIMED_PAIRS["k3"] == kl.TIMED_PAIRS["k4"] == 500_000
    # chip_smoke.py's route shape first; K4 also at K5's psi cases
    assert kl.PRNG_CHECKS[0][:5] == ("route", 500_000, 63, 0.25, 2)
    assert [c[2] % 2 for c in kl.PRNG_CHECKS[1:]] == [1, 0]
    assert [c[:3] for c in kl.K4_PSI_CHECKS] == [
        ("psi_4", 500_000, 4), ("psi_8", 500_000, 8)]
    assert all(c[-1] == kl.K5_PSI for c in kl.K4_PSI_CHECKS)


@pytest.mark.parametrize("name, short", [
    (_K1, "k1"), (_K1_POP, "k1"), (_K2, "k2"), (_K3, "k3"), (_K4, "k4"),
    (_K4_KEYS, "k4"),
    (_K5, "k5"), (_K6, "k6"), (_K7, "k7"), (_K8, "k8"), (_K9, "k9"),
    (_K10, "k10"), (_K11, "k11")])
def test_anchored_patterns_find_each_kernel_alone(name, short):
    """Over the eleven kernels' instantiations, each of the lab's patterns
    finds its own kernel and no other's, as a substring (ptxas names) and
    as a regular expression (`sass_report`): `svj_kernel` is a part of no
    other name once anchored, nor `svj_qe_kernel` of K5's, nor K1's
    `svj_draws_kernel` of K5's `svj_qe_draws_kernel`; K1's pattern finds
    the one-member kernel of earlier versions and the population kernel
    alike."""
    import re

    hits = [k for k, pat in kl._SASS_PATTERN.items() if pat in name]
    assert hits == ([short] if short else [])
    hits = [k for k, pat in kl._SASS_PATTERN.items() if re.search(pat, name)]
    assert hits == ([short] if short else [])


def test_sass_report_reads_k1_member_steps(monkeypatch):
    """A K1 pass of three members' steps with both branches holds six
    square roots (MUFU.RSQ): three member path-steps."""
    body = [(0x100 + 0x10 * i, "MUFU.RSQ", f"MUFU.RSQ R{i}, R{i + 8}")
            for i in range(6)]
    body += [(0x160 + 0x10 * i, "FADD", "FADD R1, R1, R2")
             for i in range(17)]
    body += [(0x270, "BRA", "@P0 BRA 0x100"), (0x280, "EXIT", "EXIT")]
    monkeypatch.setattr(kl, "sass_functions", lambda path: {_K1_POP: body})
    (loop,) = kl.sass_report("lib.so", kl._SASS_PATTERN["k1"])[_K1_POP][
        "loops"]
    assert loop["pair_steps"] == 3
    assert loop["hot_per_pair_step"] == 24 / 3


@pytest.mark.parametrize("name, calls, steps", [
    (_K3, 1, 2), (_K3, 2, 4), (_K4, 1, 1), (_K4_KEYS, 2, 2), (_K9, 1, 2)])
def test_k3_k4_pair_steps_from_calls(name, calls, steps):
    """K3 (and K9) make one Philox call a step pair, K4 one a pair-step."""
    assert kl.pair_steps_from_calls(name, calls) == steps


def test_sass_report_reads_k3_and_k4_pair_steps(monkeypatch):
    """A K3 pass of one Philox call covers two pair-steps, a K4 pass of
    one call one pair-step."""
    k3 = _k_listing(1)
    k4 = _k_listing(1)
    monkeypatch.setattr(kl, "sass_functions",
                        lambda path: {_K3: k3, _K4_KEYS: k4})
    rep = kl.sass_report("unused.so", "|".join(
        kl._SASS_PATTERN[k] for k in ("k3", "k4")))
    (l3,) = rep[_K3]["loops"]
    (l4,) = rep[_K4_KEYS]["loops"]
    assert l3["pair_steps"] == 2 and l4["pair_steps"] == 1
    assert l3["hot_per_pair_step"] == l3["hot_instructions"] / 2
    assert l4["hot_per_pair_step"] == l4["hot_instructions"]


def test_k3_k4_lever_versions_make_one_edit_each(monkeypatch, tmp_path):
    """Each lever of the K3 and K4 designs is found once in the package's
    sources, and its variant differs from them in that file alone: the
    contracted carries, separate sinf/cosf, the I2F uniform, no round keys,
    a minimum of 8 blocks an SM, and for K4 the eager QE transition and the
    quadratic branch on psi (the folding taken out)."""
    import os

    monkeypatch.setattr(kl, "_LAB_DIR", str(tmp_path))
    versions = kl.lever_versions(kl.ck.CSRC_DIR, ("k3", "k4"))
    assert set(versions) == {f"{k}_{lever}" for k in ("k3", "k4")
                             for lever in ("contracted", "separate_sin_cos",
                                           "i2f_uniform", "no_round_keys",
                                           "min_8_blocks")} | {
        "k4_eager_qe", "k4_unfolded_quadratic"}
    for name, work in versions.items():
        source = kl._KERNELS[name[:2]]
        changed = []
        for f_name in os.listdir(kl.ck.CSRC_DIR):
            with open(os.path.join(kl.ck.CSRC_DIR, f_name)) as a, open(
                    os.path.join(work, f_name)) as b:
                if a.read() != b.read():
                    changed.append(f_name)
        assert changed == [source], name
