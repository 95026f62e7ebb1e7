"""The parsers and the occupancy arithmetic of `mcos_tpu_torch/kernel_lab.py`
on canned compiler output: what ptxas reports, how SASS opcodes are
classed, which instructions of a loop are hot, how many pair-steps a K10 or
K11 loop pass covers, and how many blocks an SM holds. Needs no card and
no nvcc."""

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


@pytest.mark.parametrize("registers, blocks, per_sm, waves", [
    (39, 782, 6, 782 / 792),    # K9 at 200 000 pairs: one wave
    (75, 512, 3, 512 / 396),    # K11 at 75 registers: 1.29 waves
    (64, 512, 4, 512 / 528),    # K10: one wave
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
    (_K10, "rbergomi_lift_kernelILi1ELi24ELb1EE"),
    ("_ZN38_GLOBAL__N__eca620af_6_gbm_cu_21a6af4110gbm_kernelEPfxiiN4mcos"
     "10PhiloxKeysEfff", "gbm_kernel"),
    ("_ZN41_GLOBAL__N__ed5980cf_9_svj_td_cu_322ca70213svj_td_kernelILi2EEEv"
     "PfS1_S1_PKfPKdixiN4mcos10PhiloxKeysENS_8TdConstsE",
     "svj_td_kernelILi2EE"),
])
def test_short_name_keeps_one_file_per_instantiation(name, short):
    assert kl._short_name(name) == short
