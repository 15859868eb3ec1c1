"""The benchmark's reference on the CPU at 2^9 steps: the frozen oracle
accepts an honest proof and rejects every invalid kind the traffic makes,
its own walk of the wire format puts each flip inside its site, and nothing
under benchmark/ loads JAX or the JAX package (the reference loads no torch
and nothing of the port)."""

import ast
import json
import random
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.reference import oracle, verdict as ref, wire_sites

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "stark_verifier_tpu"}


@pytest.fixture(scope="module")
def proof():
    blob, out = ref.prove(3, 9, 64)
    return blob, out


def test_honest_accepts(proof):
    blob, out = proof
    assert out == ref.mimc_output(3, 9, 64)
    assert ref.verdict(blob, 3, out, 9, 64)


def test_invalid_kinds_reject(proof):
    blob, out = proof
    other, other_out = ref.prove(4, 9, 64)
    small, _ = ref.prove(3, 7, 64)
    assert ref.verdict(other, 4, other_out, 9, 64)
    assert not ref.verdict(blob[:len(blob) // 3], 3, out, 9, 64)
    assert not ref.verdict(b"", 3, out, 9, 64)
    assert not ref.verdict(small, 3, out, 9, 64)
    assert not ref.verdict(blob, 3, (out + 1) % oracle.MODULUS, 9, 64)
    assert not ref.verdict(other, 3, out, 9, 64)


@pytest.mark.parametrize("site", wire_sites.SITES)
def test_flip_in_each_site_rejects(proof, site):
    blob, out = proof
    ranges = wire_sites.site_ranges(blob)
    size = wire_sites.site_sizes(ranges)[site]
    rng = random.Random(site)
    for _ in range(2):
        off = wire_sites.byte_at(ranges, site, rng.randrange(size))
        assert any(a <= off < b for a, b in ranges[site])
        bad = wire_sites.flip(blob, off, rng.randrange(8))
        assert len(bad) == len(blob) and bad != blob
        assert not ref.verdict(bad, 3, out, 9, 64)


def test_sites_hold_what_the_oracle_parses(proof):
    """Each site's bytes, in order, are the fields the oracle's own parse
    reads for it; no two sites share a byte."""
    blob, _ = proof
    ranges = wire_sites.site_ranges(blob)
    p, end = oracle.parse_proof(blob)
    assert end == len(blob)
    fri = p.fri_levels

    def cat(xs):
        return b"".join(xs)
    want = {
        "merkle_root": p.merkle_root, "l_merkle_root": p.l_merkle_root,
        "root2": cat(l.root2 for l in fri),
        "col_value": cat(b.value for l in fri
                         for b in l.column_branches.branches),
        "col_sibling": cat(b.sibling_value for l in fri
                           for b in l.column_branches.branches),
        "col_witness": cat(w for l in fri for b in l.column_branches.branches
                           for w in b.witnesses),
        "poly_value": cat(b.value for l in fri
                          for b in l.poly_branches.branches),
        "poly_witness": cat(w for l in fri for b in l.poly_branches.branches
                            for w in b.witnesses),
        "main_value": cat(b.value for b in p.merkle_branches.branches),
        "main_witness": cat(w for b in p.merkle_branches.branches
                            for w in b.witnesses),
        "lincomb_value": cat(b.value for b in p.linear_comb_branches.branches),
        "lincomb_sibling": cat(b.sibling_value
                               for b in p.linear_comb_branches.branches),
    }
    assert set(want) == set(wire_sites.SITES)
    seen = set()
    for site in wire_sites.SITES:
        got = b"".join(blob[a:b] for a, b in ranges[site])
        assert got == want[site], site
        for a, b in ranges[site]:
            span = set(range(a, b))
            assert not span & seen, site
            seen |= span
    with pytest.raises(ValueError):
        wire_sites.site_ranges(blob[:len(blob) // 3])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_names_jax_or_the_jax_package():
    """Every import statement under benchmark/, inside functions too."""
    for path in ROOT.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def _loaded_by(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_importing_the_benchmark_loads_no_jax():
    """What importing every module of the benchmark loads (metric, driver
    and kind files through the harness's loader), in a fresh interpreter."""
    code = (
        "import importlib, json, sys, pathlib\n"
        "from benchmark import harness\n"
        "root = pathlib.Path('benchmark')\n"
        "for p in sorted(root.rglob('*.py')):\n"
        "    if p.parent.name in ('metrics', 'end_to_end', 'drivers', 'kinds'):\n"
        "        harness.load_module(p.parent.name, p.stem)\n"
        "    elif 'tests' not in p.parts:\n"
        "        importlib.import_module('.'.join(p.with_suffix('').parts)"
        ".replace('.__init__', ''))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _loaded_by(code)
    assert "benchmark" in tops
    assert not tops & FORBIDDEN


def test_reference_loads_no_port():
    code = (
        "import json, sys\n"
        "import benchmark.reference.oracle, benchmark.reference.prover\n"
        "import benchmark.reference.verdict, benchmark.reference.wire_sites\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _loaded_by(code)
    assert not tops & (FORBIDDEN | {"stark_verifier_tpu_torch", "torch"})
