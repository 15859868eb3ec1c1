"""The port's native wire parser and batched ingestion against the JAX
package's (native.parse_proof_native, proofio.ingest.ingest_chunk) and the
port's own Python walker, on fresh log_steps=9 proofs from tests/prover.py.
Trees are compared leaf by leaf through proofio.device.tree_from_reference;
tolerance 0 everywhere."""

import struct

import numpy as np
import pytest
import torch

import prover
from stark_verifier_tpu import native as jnative
from stark_verifier_tpu.config import StarkConfig as JCfg
from stark_verifier_tpu.proofio import ingest as jingest, wire as jwire
from stark_verifier_tpu_torch import native
from stark_verifier_tpu_torch.config import StarkConfig
from stark_verifier_tpu_torch.proofio import device, ingest, wire
from test_stream_independence import _synthetic_family_blob, _zero_level_proof

torch.set_num_threads(1)
CONSTS = [(i ** 7) ^ 42 for i in range(64)]
CFG, JCFG = StarkConfig(log_steps=9), JCfg(log_steps=9)


@pytest.fixture(scope="module")
def pb():
    return prover.prove_to_bytes(3, 512, CONSTS)[0]


@pytest.fixture(scope="module")
def pb7():
    """A valid proof of another family (two FRI levels fewer)."""
    return prover.prove_to_bytes(3, 128, CONSTS)[0]


def _flip(blob, at):
    b = bytearray(blob)
    b[at] ^= 1
    return bytes(b)


def _ragged(blob, depth=11):
    """The last (lincomb) branch with one witness fewer than its group."""
    at = len(blob) - 32 * depth - 4
    assert int.from_bytes(blob[at:at + 4], "little") == 32 * depth
    return (blob[:at] + (32 * (depth - 1)).to_bytes(4, "little")
            + blob[at + 4:-32])


def _proof_leaves(p):
    """Every array of a wire.ProofArrays (either package's), in order."""
    out = [p.merkle_root_words, p.l_merkle_root_words, p.points_words]
    groups = [p.main, p.lincomb]
    for lv in p.fri_levels:
        out.append(lv.root2_words)
        groups += [lv.column, lv.poly]
    for g in groups:
        out += [g.value_words, g.sibling_words, g.witness_words, g.vsizes,
                g.depths]
    return out


def _assert_trees_equal(mine, ref_np):
    """The port's int32 tree equals the JAX package's numpy tree."""
    want = device.tree_from_reference(device.tree_map(np.asarray, ref_np),
                                      "cpu")
    got_l, want_l = {}, {}
    device.tree_map(lambda a, b: None, mine, want)      # same structure
    for store, tree in ((got_l, mine), (want_l, want)):
        def walk(t, path=()):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, path + (k,))
            elif isinstance(t, list):
                for i, v in enumerate(t):
                    walk(v, path + (i,))
            else:
                store[path] = t
        walk(tree)
    assert set(got_l) == set(want_l)
    for path, x in got_l.items():
        assert x.dtype == torch.int32, path
        assert torch.equal(x, want_l[path]), path


# ---------------------------------------------------------------------------
# native parser
# ---------------------------------------------------------------------------

CASES = {
    "golden": lambda pb, pb7: pb,
    "truncated_head": lambda pb, pb7: pb[:40],
    "truncated_mid": lambda pb, pb7: pb[:len(pb) // 2],
    "truncated_tail": lambda pb, pb7: pb[:-1],
    "trailing": lambda pb, pb7: pb + b"trailing",
    "wrong_tag": lambda pb, pb7: pb[:64] + b"\x07" + pb[65:],
    "bad_size_field": lambda pb, pb7: (pb[:64 + 4 + 32 + 4]
                                       + struct.pack("<I", 33)
                                       + pb[64 + 4 + 32 + 8:]),
    "zero_fri_levels": lambda pb, pb7: _zero_level_proof(),
    "empty": lambda pb, pb7: b"",
    "other_family": lambda pb, pb7: pb7,
    "ragged": lambda pb, pb7: _ragged(pb),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("allow_trailing", [True, False])
def test_native_parser_equals_jax_and_walker(pb, pb7, case, allow_trailing):
    blob = CASES[case](pb, pb7)
    results = []
    for parse, err in (
            (native.parse_proof_native, wire.WireFormatError),
            (jnative.parse_proof_native, jwire.WireFormatError),
            (wire.parse_proof, wire.WireFormatError)):
        try:
            results.append(parse(blob, allow_trailing))
        except err:
            results.append(None)
    mine, ref, walker = results
    assert (mine is None) == (ref is None) == (walker is None), case
    if mine is None:
        return
    assert mine.consumed == ref.consumed == walker.consumed
    for a, b, c in zip(_proof_leaves(mine), _proof_leaves(ref),
                       _proof_leaves(walker)):
        assert a.dtype == np.uint32 and a.shape == b.shape == c.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_parse_and_validate_goes_through_the_native_scanner(pb, monkeypatch):
    """parse_and_validate uses the C scanner, and a scanner that cannot be
    built raises: nothing falls back to the walker."""
    calls = []
    real = native.parse_proof_native
    monkeypatch.setattr(native, "parse_proof_native",
                        lambda b, t=True: calls.append(t) or real(b, t))
    wire.parse_and_validate(pb, CFG)
    wire.parse_and_validate(pb, StarkConfig(log_steps=9, strict=True))
    assert calls == [True, False]


def test_native_build_failure_raises(monkeypatch, tmp_path):
    from stark_verifier_tpu_torch import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    monkeypatch.setitem(native._state, "lib", None)
    with pytest.raises(RuntimeError, match="wire parser"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="wire parser"):
        wire.parse_proof_fast(b"\x00" * 64)


def test_native_build_lands_in_the_build_dir(monkeypatch, tmp_path):
    from stark_verifier_tpu_torch import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(native._state, "lib", None)
    lib = native.get_lib()
    assert native.library_path().parent == tmp_path / "build"
    assert native.library_path().exists() and lib is native.get_lib()
    assert native.build_seconds() is not None
    assert not list(native.SOURCE.parent.glob("*.so"))


# ---------------------------------------------------------------------------
# ingest_chunk against the JAX package's
# ---------------------------------------------------------------------------

def _chunks(case, pb, pb7):
    """[(blobs, strict, pad_to), ...] run through one layout in turn."""
    flip = _flip(pb, 110)
    return {
        "failures_and_pads": [([pb[:100], pb, pb[:-5], flip, b""], False, 8)],
        "layout_reuse": [([pb, pb], False, None), ([pb, flip, pb], False, 3),
                         ([pb], False, None)],
        "wrong_family_head": [([pb7, pb, pb], False, None),
                              ([pb, pb7], False, None)],
        "structural_outlier": [([_ragged(pb), pb,
                                 _synthetic_family_blob(JCFG, 1),
                                 pb + b"xx"], False, None)],
        "oversized_expansion": [
            ([_synthetic_family_blob(JCFG, 1), pb, pb], False, None)],
        "deep_head_then_rebuild": [
            ([_synthetic_family_blob(JCFG, 20), pb], False, None),
            ([pb, pb], False, None)],
        "strict_trailing": [([pb + b"xx", pb, pb + b"\x00" * 4], True, None)],
        "all_garbage_keeps_layout": [([pb, pb], False, None),
                                     ([_zero_level_proof(), pb[:100]], False,
                                      None),
                                     ([pb, flip], False, None)],
        "zero_level_head": [([_zero_level_proof(), pb, pb], False, None)],
    }[case]


@pytest.mark.parametrize("case", [
    "failures_and_pads", "layout_reuse", "wrong_family_head",
    "structural_outlier", "oversized_expansion", "deep_head_then_rebuild",
    "strict_trailing", "all_garbage_keeps_layout", "zero_level_head"])
def test_ingest_chunk_equals_jax(pb, pb7, case):
    layout = jlayout = None
    for blobs, strict, pad_to in _chunks(case, pb, pb7):
        cfg = StarkConfig(log_steps=9, strict=strict)
        jcfg = JCfg(log_steps=9, strict=strict)
        tree, ok, layout2 = ingest.ingest_chunk(blobs, cfg, layout,
                                                threads=2, pad_to=pad_to)
        jtree, jok, jlayout2 = jingest.ingest_chunk(blobs, jcfg, jlayout,
                                                    threads=2, pad_to=pad_to)
        assert ok.tolist() == jok.tolist(), case
        assert (tree is None) == (jtree is None)
        assert (layout2 is None) == (jlayout2 is None)
        if layout2 is not None:
            assert layout2.key == jlayout2.key
            assert (layout2 is layout) == (jlayout2 is jlayout)
        if tree is not None:
            assert tree is layout2.tensors
            _assert_trees_equal(tree, jtree)
        layout, jlayout = layout2, jlayout2


def test_ingest_chunk_equals_its_plain_version(pb):
    blobs = [pb, _flip(pb, 3000), pb[:77], pb + b"x", pb]
    tree, ok, _ = ingest.ingest_chunk(blobs, CFG, pad_to=6)
    plain, pok = ingest.ingest_chunk_plain(blobs, CFG, pad_to=6)
    assert ok.tolist() == pok.tolist() == [True, True, False, True, True]
    device.tree_map(lambda a, b: None, tree, plain)
    device.tree_map(lambda a, b: np.testing.assert_array_equal(
        a.numpy(), b.numpy()), tree, plain)
    none, nok = ingest.ingest_chunk_plain([b"", pb[:9]], CFG)
    assert none is None and nok.tolist() == [False, False]


def test_validate_filled_reads_depths_as_uint32(pb):
    """A depth word with its top bit set is >= 1 as the reference's uint32,
    though negative in the int32 storage: the slot stays valid, as in JAX."""
    tree, ok, layout = ingest.ingest_chunk([pb, pb], CFG)
    assert ok.all()
    tree["main"]["depth"][1, 3] = -2 ** 31           # 0x80000000
    tree["fri"]["col_depth"][1, 0, 5] = -1           # 0xFFFFFFFF
    tree["lincomb"]["depth"][0, 0] = 0               # depth 0 rejects
    got = layout.validate_filled(CFG, np.ones(2, dtype=bool))
    assert got.tolist() == [False, True]


def test_fill_table_points_inside_the_layout(pb):
    """The fill table's addresses point into memory the layout owns, and a
    refill through it after other allocations lands in the same slot."""
    _t, ok, layout = ingest.ingest_chunk([pb, pb], CFG)
    t, fri = layout.tensors, layout.tensors["fri"]
    table = layout._fill_table
    assert table.shape == (2, native.SLOT_ARGS)
    assert table[1, 0] == t["merkle_root"][1].data_ptr()
    assert table[1, 14] == t["points"][1].data_ptr()
    assert table[1, 24] == t["lincomb"]["depth"][1].data_ptr()
    level = layout._level_ptrs        # [slots, 11 tables, levels]
    assert table[1, 3] == level[1, 1].ctypes.data
    assert level[1, 1, 2] == fri["col_value"][1, 2].data_ptr()
    assert level[1, 8, 1] == fri["poly_witness"][1][1].data_ptr()
    junk = [torch.zeros(1 << 16, dtype=torch.int32) for _ in range(8)]
    t["points"][1].zero_()
    rcs = layout.fill(native.get_lib(), native.Blobs([pb, pb]),
                      np.array([1]), threads=1)
    assert rcs.tolist() == [0]
    want = wire.parse_proof(pb).points_words
    np.testing.assert_array_equal(layout.tree["points"][1], want)
    del junk


def test_fill_many_checks_its_rows(pb):
    _t, ok, layout = ingest.ingest_chunk([pb], CFG)
    with pytest.raises(IndexError):
        layout.fill(native.get_lib(), native.Blobs([pb]), np.array([1]), 1)


def test_pinned_layout_needs_the_card(pb):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError):
        ingest.ingest_chunk([pb], CFG, pin=True)
