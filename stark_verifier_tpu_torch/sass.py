"""Instruction counts of the built kernels, read from their SASS.

`cuobjdump -sass` of the kernels' library lists every kernel's machine code.
This module sorts each instruction by the pipe that can run it on Hopper:

  alu_only  LOP3, SHF, PRMT, SEL, ISETP, ... : the integer ALU pipe and no
            other (16 lanes on each of an SM's 4 sub-partitions);
  add_alu   IADD3: an add on the ALU pipe;
  add_fma   IMAD* (not IMAD.MOV), VIADD: an add or multiply-add on the FMA
            pipe;
  load      global, constant and shared loads;
  other     moves, branches, stores, uniform-datapath and special registers.

and counts them over a loop body (the code between a backward branch and its
target) or over the path a thread takes through a kernel without loops.

chip_smoke.py computes its bounds' instruction counts from here on every run:
the Merkle kernels' from one compression of their level loop (a loop body
holds one compression when its PRMT count, 2 a G function, is 160), the field
kernels' from the probes of csrc/probes/work.cu (work()), which isolate the
arithmetic a unit of each kernel's function needs.  Run on a machine with the
CUDA toolkit:

    python3 -m stark_verifier_tpu_torch.sass          # builds if needed

prints one JSON object: for every kernel of the library, the per-class counts
of its common path and of one compression; under "work", each probe's.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess

from . import _build

CLASSES = ("alu_only", "add_alu", "add_fma", "load", "other")
_ALU_ONLY = {"LOP3", "LOP", "SHF", "PRMT", "SEL", "ISETP", "LEA", "IMNMX",
             "VIMNMX", "POPC", "FLO", "BMSK", "SGXT", "IABS", "PLOP3", "P2R",
             "R2P", "FSEL", "BREV"}
_LOADS = {"LDG", "LD", "LDC", "LDS", "LDL", "LDSM", "ULDC", "LDGSTS"}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[0-9T]\s+)?"
                   r"([A-Z][A-Z0-9]*)((?:\.[A-Z0-9_]+)*)\s*([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")
PRMT_PER_COMPRESSION = 160       # 80 G functions, 2 byte-permute rotates each


def classify(op: str, mods: str) -> str:
    if op in _ALU_ONLY:
        return "alu_only"
    if op == "IADD3" or op == "IADD":
        return "add_alu"
    if op == "VIADD" or (op == "IMAD" and not mods.startswith(".MOV")):
        return "add_fma"
    if op in _LOADS:
        return "load"
    return "other"


def parse(text: str) -> dict:
    """{kernel name: [(address, opcode, modifiers, operands, predicated)]},
    NOPs left out."""
    out, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            out[cur] = []
            continue
        m = _INSN.search(line) if cur else None
        if m and m.group(3) != "NOP":
            out[cur].append((int(m.group(1), 16), m.group(3), m.group(4),
                             m.group(5), m.group(2) is not None))
    return out


def counts(insns) -> dict:
    c = dict.fromkeys(CLASSES, 0)
    for _, op, mods, *_ in insns:
        c[classify(op, mods)] += 1
    c["all"] = sum(c[k] for k in CLASSES)
    return c


def _target(op: str, args: str):
    t = _TARGET.search(args) if op == "BRA" else None
    return int(t.group(1), 16) if t else None


def loops(insns) -> list:
    """The bodies of the kernel's loops: for each backward branch, the
    instructions from its target to the branch itself."""
    out = []
    for addr, op, _, args, _ in insns:
        t = _target(op, args)
        if t is not None and t < addr:
            out.append([i for i in insns if t <= i[0] <= addr])
    return out


def path(insns) -> list:
    """The instructions of one pass through the kernel that takes every
    unconditional branch and no conditional one, up to the first
    unconditional EXIT: for a kernel without loops, what a thread of the
    common case runs (the compiler lays the rare arm of an if / else, such
    as kernel E's rejected limbs, behind a conditional branch)."""
    at = {a: k for k, (a, *_) in enumerate(insns)}
    out, k = [], 0
    while k < len(insns):
        addr, op, _, args, pred = insns[k]
        out.append(insns[k])
        t = _target(op, args)
        if op == "EXIT" and not pred:
            break
        k = at[t] if t is not None and not pred and t > addr else k + 1
    return out


def per_compression(insns) -> dict | None:
    """One compression of the kernel's level loop (its smallest loop body
    that holds a whole compression: 160 PRMT), by class and by what the
    compression itself needs: "alu" its LOP3, PRMT and SHF (xors, rotates,
    the feed-forward; the ALU pipe only), "adds" its IADD3, VIADD and IMAD
    adds (IMAD.IADD, or IMAD by a register 1).  The row's loads, the 16
    selects of the message and the loop's control are in the class counts,
    not in those two."""
    best = None
    for body in loops(insns):
        ops = [(op, mods) for _, op, mods, *_ in body]
        if sum(op == "PRMT" for op, _ in ops) != PRMT_PER_COMPRESSION:
            continue
        if best is None or len(body) < len(best):
            best = body
    if best is None:
        return None
    ops = [(op, mods) for _, op, mods, *_ in best]
    c = counts(best)
    c["alu"] = sum(op in ("LOP3", "PRMT", "SHF") for op, _ in ops)
    c["adds"] = sum(op in ("IADD3", "VIADD") or
                    (op == "IMAD" and mods in ("", ".IADD")) for op, mods in ops)
    return c


def dump(lib_path: str) -> str:
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", lib_path], check=True,
                          capture_output=True, text=True, timeout=300).stdout


PROBES = _build.CSRC / "probes" / "work.cu"


def _probe_cubin() -> str:
    """csrc/probes/work.cu built for sm_90a as a cubin beside the library
    (named by the hash of the sources and the probe file)."""
    h = hashlib.sha256(_build.source_hash().encode() + PROBES.read_bytes())
    out = _build.BUILD_DIR / f"probes_{h.hexdigest()[:16]}.cubin"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        flags = [f for f in _build.NVCC_FLAGS
                 if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
        subprocess.run([_build.find_nvcc(), *flags, "-cubin", str(PROBES),
                        "-o", str(tmp)], check=True, capture_output=True,
                       text=True, timeout=600)
        os.replace(tmp, out)
    return str(out)


def work(listing: str | None = None) -> dict:
    """Per probe of csrc/probes/work.cu (or of `listing`, its SASS): its
    path's counts by class less probe_copy's (the thread index, the
    operands' addresses), with "arith" the instructions of the ALU and FMA
    pipes (alu_only + add_alu + add_fma).  Loads, stores and moves are left
    out."""
    if listing is None:
        listing = dump(_probe_cubin())
    probes = {name: counts(path(insns))
              for name, insns in parse(listing).items()}
    base = probes.pop("probe_copy")
    out = {}
    for name, c in probes.items():
        d = {k: max(c[k] - base[k], 0) for k in CLASSES}
        d["arith"] = d["alu_only"] + d["add_alu"] + d["add_fma"]
        out[name] = d
    return out


def report(lib_path: str) -> dict:
    """Per kernel (mangled name): the counts of its common path, and of one
    compression where the kernel hashes (else None)."""
    return {name: {"path": counts(path(insns)),
                   "compression": per_compression(insns)}
            for name, insns in parse(dump(lib_path)).items()}


def main():
    _build.load()
    print(json.dumps({**report(str(_build.library_path())), "work": work()},
                     indent=1))


if __name__ == "__main__":
    main()
