"""stark_verifier_tpu_torch/sass.py on made-up SASS listings: how it sorts
instructions by pipe, which path and which loop it counts, and what the
field kernels' probes leave once the copy probe is taken away.  (The real
listings come from cuobjdump on a machine with the CUDA toolkit.)"""

import pytest

from stark_verifier_tpu_torch import sass


def _listing(functions):
    """cuobjdump -sass's layout: a header line per function, one
    instruction a line with its address in a comment."""
    lines = []
    for name, insns in functions.items():
        lines.append(f"\t\tFunction : {name}")
        for k, text in enumerate(insns):
            lines.append(f"        /*{16 * k:04x}*/                   {text} ;"
                         f"   /* 0x000000000000000000000000000000 */")
    return "\n".join(lines)


COPY = ["S2R R0, SR_TID.X", "IMAD.WIDE R2, R0, 0x200, R2",
        "LDG.E.128 R4, desc[UR4][R2.64]", "STG.E.128 desc[UR4][R6.64], R4",
        "EXIT", "BRA 0x50"]


@pytest.mark.parametrize("op,mods,cls", [
    ("LOP3", ".LUT", "alu_only"), ("PRMT", "", "alu_only"),
    ("SHF", ".R.W.U32.HI", "alu_only"), ("ISETP", ".GE.U32.AND", "alu_only"),
    ("IADD3", ".X", "add_alu"), ("IMAD", ".WIDE.U32", "add_fma"),
    ("IMAD", ".IADD", "add_fma"), ("VIADD", "", "add_fma"),
    ("IMAD", ".MOV.U32", "other"), ("LDG", ".E.128", "load"),
    ("STG", ".E.128", "other")])
def test_classify_by_pipe(op, mods, cls):
    assert sass.classify(op, mods) == cls


def test_work_counts_the_arithmetic_beyond_the_copy():
    """A probe's arithmetic is what it issues beyond probe_copy on the ALU
    and FMA pipes; moves, loads, stores and the arm behind a conditional
    branch are left out."""
    probe = ["S2R R0, SR_TID.X", "IMAD.WIDE R2, R0, 0x200, R2",
             "LDG.E.128 R4, desc[UR4][R2.64]",
             "IMAD.WIDE.U32 R8, R4, R5, RZ", "IADD3 R9, P0, R8, R6, RZ",
             "IADD3.X R10, RZ, R9, RZ, P0, !PT", "LOP3.LUT R11, R9, R10, RZ",
             "ISETP.GE.U32.AND P1, PT, R11, 0x7, PT",
             "@P1 BRA 0xd0", "IMAD.MOV.U32 R12, RZ, RZ, R11",
             "STG.E.128 desc[UR4][R6.64], R8", "EXIT",
             "SEL R13, R11, RZ, P1", "BRA 0xa0"]
    got = sass.work(_listing({"probe_copy": COPY, "probe_x": probe}))
    assert set(got) == {"probe_x"}
    x = got["probe_x"]
    assert (x["alu_only"], x["add_alu"], x["add_fma"]) == (2, 2, 1)
    # other: the move and the conditional branch
    assert x["arith"] == 5 and x["load"] == 0 and x["other"] == 2


def test_per_compression_takes_the_smallest_loop_with_a_compression():
    """The level loop is the smallest loop body holding 160 PRMT; "alu"
    counts its LOP3, PRMT and SHF, "adds" its IADD3, VIADD and IMAD adds
    (not the IMAD moves or wide products)."""
    body = (["LDG.E.128 R4, desc[UR4][R2.64]"]
            + ["PRMT R5, R5, 0x1032, R5"] * 160
            + ["LOP3.LUT R6, R6, R7, RZ, 0x96, !PT"] * 3
            + ["SHF.R.W.U32.HI R7, R7, 0xc, R7"] * 2
            + ["IMAD R8, R8, R9, R10", "IMAD.IADD R8, R8, 0x1, R10",
               "IADD3 R8, R8, R9, R10", "VIADD R8, R8, 0x1",
               "IMAD.MOV.U32 R9, RZ, RZ, R8", "IMAD.WIDE R2, R0, 0x4, R2",
               "SEL R6, R6, R7, P0", "ISETP.NE.AND P0, PT, R9, RZ, PT"])
    n = len(body)
    head = ["S2R R0, SR_TID.X"]
    loop = head + body + [f"@P0 BRA 0x{16 * len(head):x}"]
    outer = loop + ["PRMT R1, R1, 0x1032, R1", "@P1 BRA 0x0", "EXIT"]
    insns = sass.parse(_listing({"k": outer}))["k"]
    assert len(sass.loops(insns)) == 2
    one = sass.per_compression(insns)
    assert one["alu"] == 165 and one["adds"] == 4
    assert one["all"] == n + 1
    assert sass.per_compression(sass.parse(_listing({"k": COPY}))["k"]) is None
