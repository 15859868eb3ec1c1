"""The CUDA kernels' per-thread bodies, compiled for the host, against their
plain PyTorch versions.

Each kernel in stark_verifier_tpu_torch/csrc is one thread per work item and
its body is a __host__ __device__ function; a plain C++ compiler builds the
same body behind the same C entry point as a loop over the items.  That lets
the kernels' arithmetic (the 8 x 32-bit field core, the register Blake2s, the
index and stride handling) be checked where there is no card; the kernels
themselves are held against the same plain versions on the card by
chip_smoke.py.  Tolerance 0: everything is integer arithmetic.
"""

import ctypes
import hashlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from stark_verifier_tpu_torch import _build, fp
from stark_verifier_tpu_torch.config import StarkConfig, cached_tables
from stark_verifier_tpu_torch.ops import (
    blake2s, blake2s_cuda, field as F, field_cuda, fri_cuda, merkle_cuda,
    mimc, ntt, prg, spot_cuda)

torch.set_num_threads(1)
P = fp.MODULUS


@pytest.fixture(scope="module")
def hostlib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("csrc_host") / "libstark_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
         "-o", str(out), *map(str, _build.sources())], check=True,
        timeout=60)
    return _build.declare(ctypes.CDLL(str(out)))


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def _words(rng, shape):
    w = rng.randint(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    flat[0::7] = 0xFFFFFFFF          # sign-bit patterns in every operand
    flat[3::11] = 0x80000000
    return _i32(w)


def _start_index(n, depth):
    idx = np.arange(n, dtype=np.uint32) * 5 % (1 << (depth + 1))
    ld4 = 1 << (depth - 1)
    return _i32((1 << (depth + 2)) + idx // ld4 + 4 * (idx % ld4))


def _group(val, sib, wit, ti, depth, out, vstride, wit_stride, levels):
    """A descriptor of the grouped walks (kernel A when depth is None)."""
    return _build.WalkGroup(
        val.data_ptr(), sib.data_ptr(), wit.data_ptr(), ti.data_ptr(),
        None if depth is None else depth.data_ptr(), out.data_ptr(),
        vstride, wit_stride, out.numel() // 8, val.shape[-1], levels, 0)


def _walk(fn, groups):
    return fn((_build.WalkGroup * len(groups))(*groups), len(groups), None)


@pytest.mark.parametrize("vw,depth,levels", [(8, 4, 3), (8, 12, 12),
                                             (24, 12, 12), (24, 5, 0),
                                             (8, 4, 2)])
def test_host_walk_leaf_levels(hostlib, vw, depth, levels):
    rng = np.random.RandomState(vw + levels)
    n = 37
    val, sib = _words(rng, (n, vw)), _words(rng, (n, vw))
    wit = _words(rng, (n, depth, 8))
    ti = _start_index(n, depth)
    out = torch.empty((n, 8), dtype=torch.int32)
    rc = _walk(hostlib.stark_walk_leaf_levels_groups,
               [_group(val, sib, wit, ti, None, out, vw, depth * 8, levels)])
    assert rc == 0
    want = merkle_cuda.walk_leaf_levels_plain(val, sib, wit, ti, levels)
    np.testing.assert_array_equal(out.numpy(), want.numpy())


def test_host_walk_rejects_bad_width(hostlib):
    z = torch.zeros(64, dtype=torch.int32)
    bad = _build.WalkGroup(z.data_ptr(), z.data_ptr(), z.data_ptr(),
                           z.data_ptr(), None, z.data_ptr(), 16, 8, 1, 16, 1,
                           0)
    assert _walk(hostlib.stark_walk_leaf_levels_groups, [bad]) != 0


def _mixed_groups(rng, depth_per_branch):
    """Operands of four groups of one walk: widths 24, 8, 8 and (kernel F
    only) 5, different level counts, one group of a single branch."""
    specs = [(24, 7, 6), (8, 9, 4), (8, 1, 2)]
    if depth_per_branch:
        specs.append((5, 11, 3))
    groups = []
    for vw, n, depth in specs:
        val, sib = _words(rng, (n, vw)), _words(rng, (n, vw))
        wit = _words(rng, (n, depth, 8))
        ti = _start_index(n, depth)
        d = _i32((np.arange(n) % (depth + 2)).astype(np.uint32))
        groups.append((val, sib, wit, ti, d if depth_per_branch else None,
                       depth))
    return groups


@pytest.mark.parametrize("kernel", ["walk_leaf_levels", "walk_branches"])
@pytest.mark.parametrize("order", ["as_made", "reversed"])
def test_host_walk_groups(hostlib, kernel, order):
    """Several groups in one call of the grouped entry point: each group's
    digests equal its plain version's, whatever order the table lists the
    groups in (the entry point walks the heaviest first)."""
    f = kernel == "walk_branches"
    rng = np.random.RandomState(17)
    groups = _mixed_groups(rng, f)
    if order == "reversed":
        groups = groups[::-1]
    outs = [torch.full((val.shape[0], 8), 7, dtype=torch.int32)
            for val, *_ in groups]
    descs = [_group(val, sib, wit, ti, d, out, val.shape[-1], depth * 8,
                    depth - (0 if f else 1))
             for (val, sib, wit, ti, d, depth), out in zip(groups, outs)]
    rc = _walk(getattr(hostlib, f"stark_{kernel}_groups"), descs)
    assert rc == 0
    for (val, sib, wit, ti, d, depth), out in zip(groups, outs):
        want = (merkle_cuda.walk_branches_plain(val, sib, wit, ti, d) if f
                else merkle_cuda.walk_leaf_levels_plain(val, sib, wit, ti,
                                                        depth - 1))
        np.testing.assert_array_equal(out.numpy(), want.numpy())


@pytest.mark.parametrize("fault", [
    "a_width", "f_width", "vstride", "levels", "value_alignment",
    "witness_stride", "no_depth", "count", "branches"])
def test_host_walk_groups_reject_a_bad_table(hostlib, fault):
    """One bad descriptor or a count above 32: the entry point returns 1
    and writes nothing, not even the good groups' digests."""
    f = fault not in ("a_width",)
    rng = np.random.RandomState(3)
    groups = _mixed_groups(rng, True)[:2]
    outs = [torch.full((val.shape[0], 8), 7, dtype=torch.int32)
            for val, *_ in groups]
    descs = [_group(val, sib, wit, ti, d if f else None, out, val.shape[-1],
                    depth * 8, depth)
             for (val, sib, wit, ti, d, depth), out in zip(groups, outs)]
    bad, count = descs[1], len(descs)
    if fault in ("a_width", "f_width"):
        bad.vw = 16 if fault == "a_width" else 0
    elif fault == "vstride":
        bad.vstride = bad.vw - 1
    elif fault == "levels":
        bad.levels = -1
    elif fault == "value_alignment":
        bad.value += 4
    elif fault == "witness_stride":
        bad.wit_stride += 2
    elif fault == "no_depth":
        bad.depth = None
    elif fault == "count":
        descs = descs * 17
        count = len(descs)
    else:
        bad.n = -1
    fn = hostlib.stark_walk_branches_groups if f else \
        hostlib.stark_walk_leaf_levels_groups
    table = (_build.WalkGroup * len(descs))(*descs)
    assert fn(table, count, None) == 1
    for out in outs:
        assert (out == 7).all()


def _quad_groups(rng, specs):
    """Operands of quad groups (q quads, witness depth, levels after the
    combine): b's sibling is b+1's value, every branch's first witness the
    other pair's digest except branch 1's in quad 1 of each group of two
    quads or more."""
    groups = []
    for q, depth, levels in specs:
        val = _words(rng, (q, 4, 8))
        sib = val[:, [1, 0, 3, 2], :].clone()
        wit = _words(rng, (q, 4, depth, 8))
        pairs = blake2s.hash_leaf_pair(val[:, 0::2], sib[:, 0::2])
        wit[:, 0:2, 0] = pairs[:, None, 1]
        wit[:, 2:4, 0] = pairs[:, None, 0]
        if q > 1:
            wit[1, 1, 0, 5] ^= 1
        groups.append((val.reshape(4 * q, 8), sib.reshape(4 * q, 8),
                       wit.reshape(4 * q, depth, 8),
                       _start_index(4 * q, depth), levels))
    return groups


@pytest.mark.parametrize("levels", [3, 11, 0])
def test_host_walk_quads(hostlib, levels):
    """Kernel B's body against its plain version: quad groups with `levels`
    chain levels beside a group of 5 levels and a group of one quad, in one
    call, through the wrapper's own descriptors (the chain reads a level
    slice of one branch in four)."""
    rng = np.random.RandomState(20 + levels)
    groups = _quad_groups(rng, [(6, levels + 2, levels), (3, 7, 5),
                                (1, 2, 0)])
    outs = [(torch.full((val.shape[0] // 4, 8), 7, dtype=torch.int32),
             torch.full((val.shape[0] // 4,), 7, dtype=torch.int32))
            for val, *_ in groups]
    descs = []
    for (val, sib, wit, ti, lv), (out, ok) in zip(groups, outs):
        stride = merkle_cuda._witness_stride(wit, 1, lv + 1)
        assert stride == wit.shape[-2] * 8
        d = _group(val, sib, wit, ti, None, out, 8, stride, lv)
        d.ok = ok.data_ptr()
        descs.append(d)
    assert _walk(hostlib.stark_walk_quads_groups, descs) == 0
    for g, (out, ok) in zip(groups, outs):
        want, want_ok = merkle_cuda.walk_quads_plain(*g)
        np.testing.assert_array_equal(out.numpy(), want.numpy())
        np.testing.assert_array_equal(ok.numpy(), want_ok.numpy())
        assert ok.tolist()[:2] == [1, 0][:len(ok)]


@pytest.mark.parametrize("fault", ["width", "no_ok", "witness_alignment",
                                   "quads"])
def test_host_walk_quads_reject_a_bad_table(hostlib, fault):
    """A quad group kernel B cannot walk: the entry point returns 1 and
    writes nothing.  Its first witness rows are read at zero levels too."""
    rng = np.random.RandomState(4)
    (val, sib, wit, ti, _), = _quad_groups(rng, [(3, 4, 0)])
    out = torch.full((3, 8), 7, dtype=torch.int32)
    ok = torch.full((3,), 7, dtype=torch.int32)
    d = _group(val, sib, wit, ti, None, out, 8, 32, 0)
    d.ok = ok.data_ptr()
    assert _walk(hostlib.stark_walk_quads_groups, [d]) == 0
    out.fill_(7)
    ok.fill_(7)
    if fault == "width":
        d.vw = d.vstride = 24                        # A's width, not B's
    elif fault == "no_ok":
        d.ok = None
    elif fault == "witness_alignment":
        d.witness += 4
    else:
        d.n = -1
    assert _walk(hostlib.stark_walk_quads_groups, [d]) == 1
    assert (out == 7).all() and (ok == 7).all()


def _limbs(vals):
    return _i32(fp.ints_to_limbs(vals))


def _special(rng, n):
    vals = [0, 1, P - 1, P, P + 1, 2**256 - 1, 2**256 - 2**32, P - 2]
    vals += [int.from_bytes(rng.bytes(32), "big") for _ in range(n - len(vals))]
    return vals[:n]


def _be_words(x):
    return F.limbs_to_words_be(_limbs([x]))[0]


def _fri_operands(rng, b, nl, q, strided=True):
    """Kernel C's operands on the CPU for b proofs of nl levels and q
    queries: poly rows read in place with a proof stride wider than their
    rows (a slice of longer rows, as a chunk of a batch may be), raw words
    (0xFFFFFFFF and sign-bit words, values >= p), column indices over the
    32-bit range with 0 and the top on the last level, roots >= p, the
    packed power table of a small statement; the committed values hold at
    every even query except a tampered one, and a query whose value is
    right but not canonical, and constant rows whose committed value is
    the constant."""
    tables = cached_tables(StarkConfig(log_steps=9))
    pad = 8 if strided else 0
    poly = _words(rng, (b, nl * 4 * q * 8 + pad))[:, pad:].view(
        b, nl, 4 * q, 8)
    col = _words(rng, (b, nl, q, 8))
    ys = torch.from_numpy(
        rng.randint(0, 2**32, (b, nl, q), dtype=np.uint64).astype(np.int64))
    ys[0, -1, :2] = torch.tensor([0, 2**32 - 1])
    lroot, root2 = _words(rng, (b, 8)), _words(rng, (b, nl, 8))
    lroot[0] = -1                                   # 2^256 - 1
    root2[-1, 0] = _be_words(P)
    poly[-1, 2, 0:4] = torch.stack([_be_words(v) for v in (5, P + 5, 5, 5)])
    poly[-1, 2, 12:16] = _be_words(P + 5)
    # constant rows c at even queries, where the committed value is c:
    # 4 c carries past 2^256 once it is folded (the first two), or not
    for (lv, k), c in zip(((1, 0), (1, 2), (0, 2)),
                          (2**255 - 1, 3 * 2**254 - 1, P - 1)):
        poly[-1, lv, 4 * k:4 * k + 4] = _be_words(c)
    g2w = _i32(fp.limbs_to_le_words(tables.g2_powers))
    ops = [poly, col, ys, lroot, root2, g2w, tables.quartic_ginv, tables.inv4]
    _, lhs = fri_cuda.fri_rows_plain(*ops)
    col[:, :, 0::2] = lhs[:, :, 0::2]
    col[0, 1, 2, 7] ^= 1
    col[-1, 2, 3] = _be_words(P + 5)
    return ops


def _host_fri(hostlib, ops, want_lhs):
    args, ok, lhs, keep = fri_cuda._fri_args(*ops, want_lhs)
    ok.view(torch.uint8).fill_(9)
    rc = hostlib.stark_fri_rows(args, None)
    assert ok.view(torch.uint8).max() <= 1          # every byte written
    return rc, ok, lhs


def test_host_eval4_rows(hostlib):
    """Kernel C's body against its plain version, poly rows read with their
    proof stride: the ok bytes and the evaluations' words."""
    rng = np.random.RandomState(5)
    ops = _fri_operands(rng, 3, 5, 6)
    want_ok, want_lhs = fri_cuda.fri_rows_plain(*ops)
    assert want_ok[:, :, 0::2].sum() == 3 * 5 * 3 - 1 and want_ok[-1, 2, 0]
    assert not want_ok[:, :, 1::2].any()
    assert want_lhs[-1, 1, 2].tolist() == _be_words(3 * 2**254 - 1).tolist()
    args, *_ = fri_cuda._fri_args(*ops, True)
    assert (args.poly_stride, args.col_stride, args.root2_stride) == (
        5 * 24 * 8 + 8, 5 * 6 * 8, 40)
    rc, ok, lhs = _host_fri(hostlib, ops, True)
    assert rc == 0
    np.testing.assert_array_equal(ok.numpy(), want_ok.numpy())
    np.testing.assert_array_equal(lhs.numpy(), want_lhs.numpy())


def test_host_fri_rows_one_proof_no_words(hostlib):
    """One proof with no batch axis (proof strides 0), dense rows, and no
    evaluation words asked for: the ok bytes alone."""
    rng = np.random.RandomState(6)
    ops = [t[1] if isinstance(t, torch.Tensor) and i < 5 else t
           for i, t in enumerate(_fri_operands(rng, 2, 3, 4, strided=False))]
    want_ok, _ = fri_cuda.fri_rows_plain(*ops)
    assert want_ok.shape == (3, 4) and want_ok[2, 0] and not want_ok[2, 3]
    rc, ok, lhs = _host_fri(hostlib, ops, False)
    assert rc == 0 and lhs is None
    np.testing.assert_array_equal(ok.numpy(), want_ok.numpy())


@pytest.mark.parametrize("fault", ["queries", "levels", "many_levels",
                                   "no_table", "rows", "poly_alignment",
                                   "count"])
def test_host_fri_rows_rejects_bad_arguments(hostlib, fault):
    """An argument kernel C cannot take: the entry point returns 1 and
    writes nothing."""
    rng = np.random.RandomState(2)
    ops = _fri_operands(rng, 2, 3, 4)
    args, ok, lhs, keep = fri_cuda._fri_args(*ops, True)
    ok.view(torch.uint8).fill_(9)
    lhs.fill_(7)
    if fault == "queries":
        args.q = 0
    elif fault == "levels":
        args.levels = -3
    elif fault == "many_levels":
        args.levels, args.n = 17, 17 * 4
    elif fault == "no_table":
        args.g2 = None
    elif fault == "rows":
        args.rows = 24
    elif fault == "poly_alignment":
        args.poly += 4
    else:
        args.n = 23                                  # not whole proofs
    assert hostlib.stark_fri_rows(args, None) == 1
    assert (ok.view(torch.uint8) == 9).all() and (lhs == 7).all()


def _spot_operands(rng, b, g, power, k_rows=8):
    """Kernel D's operands on the CPU for b proofs of g positions: raw words
    (0xFFFFFFFF and sign-bit words, values >= p), small packed tables (a K
    table of k_rows rows), and each family made to hold at one position."""
    main = _words(rng, (b, 2 * g, 24))
    lin = _words(rng, (b, g, 8))
    kh = _words(rng, (b, 4, 8))
    pos = torch.from_numpy(rng.randint(0, 1 << 20, (b, g)).astype(np.int64))
    ic1 = F.canon(_limbs(_special(rng, b)))
    ic0 = F.canon(_limbs(list(reversed(_special(rng, b)))))
    tables = spot_cuda.SpotTables(
        *(F.limbs_to_words_le(F.canon(_limbs(_special(rng, rows)))).contiguous()
          for rows in (32, 32, 32, k_rows)), log_steps=2)
    # the plain version's own limbs and gathers, to make each family hold
    mv = main.reshape(b, g, 2, 3, 8)
    p, d, bb = (F.canon(F.words_be_to_limbs(mv[..., 0, j, :]))
                for j in (0, 1, 2))
    gath = lambda t, i: F.words_le_to_limbs(t[i])          # noqa: E731
    x, xs = gath(tables.g2, pos & 31), gath(tables.g2, (pos << 2) & 31)
    z, z2 = gath(tables.z, pos & 31), gath(tables.z2, pos & 31)
    k = gath(tables.k, pos & (k_rows - 1))
    ks = F.words_be_to_limbs(kh)[:, None]
    p_pow = [(F.sqr_mod(p), p)] if power == 3 else [(p, p)]
    mv[0, 1, 1, 0] = F.limbs_to_words_be(F.mul_sum_mod(
        p_pow + [(z, d)], extra=[k]))[0, 1]
    lin[1, 2] = F.limbs_to_words_be(F.mul_sum_mod(
        [(ks[..., 0, :], p), (ks[..., 1, :], F.mul_mod(p, xs)),
         (ks[..., 2, :], bb), (ks[..., 3, :], F.mul_mod(bb, xs))],
        extra=[d]))[1, 2]
    mv[2, 0, 0, 0] = F.limbs_to_words_be(F.mul_sum_mod(
        [(bb, z2), (ic1[:, None], x)], extra=[ic0[:, None].expand(x.shape)]))[2, 0]
    return (main, lin, pos, kh, ic1, ic0, tables)


def _host_spot(hostlib, ops, power):
    args, ok, keep = spot_cuda._spot_args(*ops, power)
    ok.view(torch.uint8).fill_(9)
    rc = hostlib.stark_spot_checks(args, None)
    assert ok.view(torch.uint8).max() <= 1          # every byte written
    return rc, ok


@pytest.mark.parametrize("power", [3, 2])
def test_host_spot_checks(hostlib, power):
    """Kernel D's four parts, run in turn by the host loop, against the
    plain version on the proof's words and the packed tables."""
    rng = np.random.RandomState(7 + power)
    ops = _spot_operands(rng, 3, 9, power)
    want = spot_cuda.spot_checks_plain(*ops, power=power)
    assert want[0, 1, 0] and want[1, 2, 2] and want[2, 0, 1]
    assert not want.all()
    rc, got = _host_spot(hostlib, ops, power)
    assert rc == 0
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("k_rows", [8, 64])
def test_host_spot_boundary_holds(hostlib, k_rows):
    """A K table with more rows than the positions reach below it (the
    runtime-statement path's own table), one interpolant row for every
    proof (stride 0), and a position whose boundary constraint holds, which
    sets bit 1 only."""
    rng = np.random.RandomState(3)
    ops = list(_spot_operands(rng, 3, 5, 3, k_rows=k_rows))
    want = spot_cuda.spot_checks_plain(*ops, power=3)
    assert want[2, 0].tolist() == [False, True, False]
    assert want[0, 1, 0] and want[1, 2, 2]
    rc, got = _host_spot(hostlib, ops, 3)
    assert rc == 0
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    ops[4], ops[5] = ops[4][0], ops[5][0]            # one row for all
    want = spot_cuda.spot_checks_plain(*ops, power=3)
    args, _, _ = spot_cuda._spot_args(*ops, 3)
    assert (args.ic1_stride, args.ic0_stride, args.main_stride) == (0, 0, 240)
    rc, got = _host_spot(hostlib, ops, 3)
    assert rc == 0
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("fault", ["power", "positions", "rows", "k_rows",
                                   "main_alignment", "group", "log_steps"])
def test_host_spot_rejects_bad_arguments(hostlib, fault):
    """An argument kernel D cannot take: the entry point returns 1 and
    writes nothing."""
    rng = np.random.RandomState(2)
    ops = _spot_operands(rng, 3, 4, 3)
    args, ok, keep = spot_cuda._spot_args(*ops, 3)
    ok.view(torch.uint8).fill_(9)
    if fault == "power":
        args.power = 4
    elif fault == "positions":
        args.n = 1 << 31                             # 32-bit position index
    elif fault == "rows":
        args.rows = 24
    elif fault == "k_rows":
        args.k_rows = 6
    elif fault == "main_alignment":
        args.main += 4
    elif fault == "group":
        args.group = 5                               # 12 positions
    else:
        args.log_steps = 63
    assert hostlib.stark_spot_checks(args, None) == 1
    assert (ok.view(torch.uint8) == 9).all()


@pytest.mark.parametrize("shape_a,shape_b", [
    ((40, 16), (40, 16)), ((40, 16), (16,)), ((16,), (40, 16)),
    ((5, 8, 16), (8, 16)), ((5, 1, 16), (1, 8, 16)), ((16,), (16,))])
def test_host_mul_mod(hostlib, shape_a, shape_b):
    """Kernel E's body against its plain version: raw operands (edge values
    on both sides), every broadcast the wrapper turns into a period or a
    materialized copy."""
    rng = np.random.RandomState(11)

    def operand(shape, rev):
        n = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        vals = _special(rng, max(n, 8))[:n]
        return _limbs(vals[::-1] if rev else vals).reshape(shape)

    a, b = operand(shape_a, False), operand(shape_b, True)
    want = field_cuda.mul_mod_plain(a, b)
    lead = tuple(want.shape[:-1])
    (ac, ap), (bc, bp) = field_cuda._period(a, lead), field_cuda._period(b, lead)
    out = torch.empty(lead + (16,), dtype=torch.int32)
    rc = hostlib.stark_mul_mod(ac.data_ptr(), ap, bc.data_ptr(), bp,
                               out.data_ptr(), out.numel() // 16, None)
    assert rc == 0
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    ints = [fp.limbs_to_int(r) for r in
            want.numpy().astype(np.uint32).reshape(-1, 16)]
    ai = [fp.limbs_to_int(r) for r in a.expand(lead + (16,)).numpy()
          .astype(np.uint32).reshape(-1, 16)]
    bi = [fp.limbs_to_int(r) for r in b.expand(lead + (16,)).numpy()
          .astype(np.uint32).reshape(-1, 16)]
    assert ints == [x * y % P for x, y in zip(ai, bi)]


def test_host_mul_mod_rejects_wide_limbs(hostlib):
    """A limb of 2^16 or more, or a negative one, on either side: sixteen
    words of 0xFFFFFFFF for that element and no other, in the kernel's body
    as in the plain version."""
    a = _limbs([3, 5, 7, 11])
    b = _limbs([13, 17, 19, 23])
    a[1, 4] = 1 << 16
    b[2, 15] = -1
    want = field_cuda.mul_mod_plain(a, b)
    assert (want[1] == -1).all() and (want[2] == -1).all()
    assert fp.limbs_to_int(want[0].numpy().astype(np.uint32)) == 39
    out = torch.empty((4, 16), dtype=torch.int32)
    assert hostlib.stark_mul_mod(a.data_ptr(), 4, b.data_ptr(), 4,
                                 out.data_ptr(), 4, None) == 0
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    assert hostlib.stark_mul_mod(a.data_ptr(), 0, b.data_ptr(), 4,
                                 out.data_ptr(), 4, None) != 0


@pytest.mark.parametrize("vw,max_depth", [(8, 5), (24, 5), (16, 4), (8, 0),
                                          (3, 2)])
def test_host_walk_branches(hostlib, vw, max_depth):
    """Kernel F's body against its plain version: a depth per branch from 0
    up to and past max_depth (clamped), widths with the vector-load leaf
    hash (8, 24) and the word-by-word one."""
    rng = np.random.RandomState(vw + max_depth)
    n = 41
    val, sib = _words(rng, (n, vw)), _words(rng, (n, vw))
    wit = _words(rng, (n, max_depth, 8))
    depth = _i32((np.arange(n) % (max_depth + 3)).astype(np.uint32))
    depth[7] = -1                                  # 0xFFFFFFFF: clamped
    ti = _words(rng, (n,))
    out = torch.empty((n, 8), dtype=torch.int32)
    rc = _walk(hostlib.stark_walk_branches_groups,
               [_group(val, sib, wit, ti, depth, out, vw, max_depth * 8,
                       max_depth)])
    assert rc == 0
    want = merkle_cuda.walk_branches_plain(val, sib, wit, ti, depth)
    np.testing.assert_array_equal(out.numpy(), want.numpy())


def test_host_walk_branches_column_slice_and_padded_witness(hostlib):
    """Value rows read in place from wider rows (the per-class launches of a
    ragged group), and a witness array one level deeper than every depth:
    the padded level is never hashed."""
    rng = np.random.RandomState(9)
    n, depth = 12, 3
    val, sib = _words(rng, (n, 24)), _words(rng, (n, 24))
    wit = _words(rng, (n, depth, 8))
    padded = torch.cat([wit, torch.zeros((n, 1, 8), dtype=torch.int32)], 1)
    d = _i32(np.full(n, depth, dtype=np.uint32))
    ti = _start_index(n, depth)
    want = merkle_cuda.walk_branches_plain(val[:, :8], sib[:, :8], wit, ti, d)
    np.testing.assert_array_equal(
        want.numpy(),
        merkle_cuda.walk_leaf_levels_plain(val[:, :8], sib[:, :8], wit, ti,
                                           depth).numpy())
    out = torch.empty((n, 8), dtype=torch.int32)
    group = _group(val[:, :8], sib[:, :8], padded, ti, d, out, 24,
                   (depth + 1) * 8, depth + 1)
    assert _walk(hostlib.stark_walk_branches_groups, [group]) == 0
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    group.vstride = 4
    assert _walk(hostlib.stark_walk_branches_groups, [group]) != 0


@pytest.mark.parametrize("row,cols", [(10, (0, 8)), (26, (2, 26))])
def test_host_walk_branches_groups_keep_their_row_copies(hostlib, row, cols):
    """Value rows of 8 or 24 words that are not 16-byte aligned (a column
    slice of wider rows) are walked from dense copies.  The descriptors of
    one launch point into every group's copies, so the copies must outlive
    the whole table, not only the group that made them: tensors allocated
    after the table is built (the next groups' copies and digests on the
    card) must not take their memory."""
    rng = np.random.RandomState(row)
    lo, hi = cols
    groups = []
    for n, depth in ((9, 4), (9, 3), (5, 2)):
        val, sib = _words(rng, (n, row)), _words(rng, (n, row))
        wit = _words(rng, (n, depth, 8))
        d = _i32(np.full(n, depth, dtype=np.uint32))
        groups.append((val[:, lo:hi], sib[:, lo:hi], wit,
                       _start_index(n, depth), d))
    descs, outs, rows = merkle_cuda._branch_table(groups, torch.device("cpu"))
    for desc, (val, sib) in zip(descs, rows):
        assert val.is_contiguous() and val.data_ptr() % 16 == 0
        assert (desc.value, desc.sibling) == (val.data_ptr(), sib.data_ptr())
    later = [torch.full_like(t, 7) for val, sib in rows for t in (val, sib)
             for _ in range(4)]
    kept = {(t.data_ptr(), t.data_ptr() + t.numel() * 4)
            for val, sib in rows for t in (val, sib)}
    assert not any(a < t.data_ptr() + t.numel() * 4 and t.data_ptr() < b
                   for a, b in kept for t in later)
    assert _walk(hostlib.stark_walk_branches_groups, descs) == 0
    for g, out in zip(groups, outs):
        np.testing.assert_array_equal(
            out.numpy(), merkle_cuda.walk_branches_plain(*g).numpy())


# ---------------------------------------------------------------------------
# the NTT stage kernel, driven through ops/ntt's card path
# ---------------------------------------------------------------------------

EDGES = [0, 1, P - 1, P, P + 1, 2**256 - 1, 2**256 - 2**32, 2**224 - 1,
         int("FFFFFFFF00000000" * 4, 16), 2**255]


def _root(n):
    return pow(7, (P - 1) // n, P)


def _raw(n, seed, lead=()):
    """[*lead, n, 16] raw values below 2^256, the edge values first."""
    rng = np.random.RandomState(seed)
    count = n * int(np.prod(lead, dtype=np.int64))
    v = rng.randint(0, 1 << 16, (count, 16)).astype(np.uint32)
    k = min(count, len(EDGES))
    v[:k] = fp.ints_to_limbs(EDGES[:k])
    return v.reshape(tuple(lead) + (n, 16))


def _np32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("n,lead", [(1, (3,)), (2, (3,)), (8, ()),
                                    (256, (3,)), (1 << 10, ()), (4, (3,)),
                                    (16, (2,)), (64, (2,)), (1 << 11, (2,)),
                                    (1 << 12, ()), (1 << 13, (2,)),
                                    (32, (3,)), (128, (2,)), (512, (2,))])
def test_host_ntt_kernel_path_equals_plain(hostlib, n, lead):
    """The card path (the first pass gathering from the caller's limbs,
    passes between in place on the 8-word buffer, the last writing limbs
    scaled by n^-1; one pass up to 2^10 points, two from 2^11) through the
    host build, forward and inverse, raw edge values (p, p + 1, 2^256 - 1
    among them): equal to the plain version word for word; the caller's
    tensor is not written."""
    x = _i32(_raw(n, n, lead))
    keep = x.clone()
    for inverse in (False, True):
        got = ntt.ntt_kernel(x, _root(n), inverse, lib=hostlib)
        np.testing.assert_array_equal(
            _np32(got), _np32(ntt.ntt_plain(x, _root(n), inverse)))
    assert torch.equal(x, keep)


def test_host_ntt_round_trip_2_16(hostlib):
    n = 1 << 16
    rng = np.random.RandomState(16)
    x = _i32(rng.randint(0, 1 << 16, (n, 16)).astype(np.uint32) % 0xFFFF)
    before = dict(ntt.launches)
    y = ntt.ntt_kernel(x, _root(n), lib=hostlib)
    back = ntt.ntt_kernel(y, _root(n), inverse=True, lib=hostlib)
    # two passes of 8 stages a transform (not 16 stage launches each)
    assert ntt.launches["ntt_block"] - before["ntt_block"] == 4
    assert ntt.launches["ntt_stage"] - before["ntt_stage"] == 0
    np.testing.assert_array_equal(_np32(back), _np32(x))
    # one output point against its Horner evaluation
    vals = [fp.limbs_to_int(r) for r in _np32(x)]
    w = pow(_root(n), 12345, P)
    acc = 0
    for c in reversed(vals):
        acc = (acc * w + c) % P
    assert fp.limbs_to_int(_np32(y)[12345]) == acc


def test_host_ntt_strided_input(hostlib):
    """A sliced, strided input takes the wrapper's canonical-stride copy."""
    base = _i32(_raw(64, 3, (2,)))
    x = base[:, ::2]                                    # [2, 32, 16] strided
    got = ntt.ntt_kernel(x, _root(32), lib=hostlib)
    np.testing.assert_array_equal(
        _np32(got), _np32(ntt.ntt_plain(x.contiguous(), _root(32))))


def test_host_ntt_cross_stage(hostlib):
    """The sharded NTT's cross stage: pairs (a[j], b[j]) with the twiddle of
    row (off + j) * (rows >> s), lo then hi, scaled when asked."""
    n, s, off = 64, 4, 8                        # a stage of half 16 = 2^s
    w = _root(n)
    _, tw = ntt._card_tables(w, n, P, "cpu")
    a, b = _i32(_raw(8, 5)), _i32(_raw(8, 6))
    for scale in (None, ntt._scale_words(n, P, "cpu")):
        got = ntt.cross_stage(a, b, tw, s, off, scale, lib=hostlib)
        pows = [pow(w, (off + j) * (n >> (s + 1)), P) for j in range(8)]
        k = pow(n, P - 2, P) if scale is not None else 1
        av = [fp.limbs_to_int(r) for r in _np32(a)]
        bv = [fp.limbs_to_int(r) for r in _np32(b)]
        lo = [(x + y * t) * k % P for x, y, t in zip(av, bv, pows)]
        hi = [(x - y * t) * k % P for x, y, t in zip(av, bv, pows)]
        got_i = [[fp.limbs_to_int(r) % P for r in _np32(h)] for h in got]
        assert got_i == [lo, hi]


@pytest.mark.parametrize("n,shards", [(64, 4), (1 << 12, 2)])
def test_host_ntt_local_stages_of_a_shard(hostlib, n, shards):
    """ops/ntt.stages as the sharded NTT runs a rank's local stages: a perm
    slice of the whole transform's, count = log2(n / shards) < log2 n, the
    whole transform's power table (one pass at 16 points, two at 2,048):
    equal to the plain stages on the same gathered points."""
    w = _root(n)
    perm, tw = ntt._card_tables(w, n, P, "cpu")
    x = _i32(_raw(n, n + 1))
    s = n // shards
    logs = s.bit_length() - 1
    for r in range(shards):
        got = ntt.stages(x.reshape(1, n, 16), perm[r * s:(r + 1) * s], s,
                         logs, tw, lib=hostlib)[0]
        want = x[perm[r * s:(r + 1) * s].long()]
        for t in ntt._twiddle_stages(w, n, P)[:logs]:
            want = ntt.stage_plain(want, _i32(t))
        np.testing.assert_array_equal(_np32(got), _np32(want))


def test_host_ntt_block_butterfly_at_edge_operands(hostlib):
    """The pass kernel's butterfly (its 16-limb product and three folds)
    on every pair of edge values as (b, w), each a as well: one stage of
    2-point transforms, one transform a (a, b), against the plain stage."""
    vals = fp.ints_to_limbs(EDGES)
    m = len(EDGES)
    x = _i32(np.stack([np.stack([vals[i], vals[j]]) for i in range(m)
                       for j in range(m)]))                 # [m^2, 2, 16]
    out = torch.empty_like(x)
    perm = torch.arange(2, dtype=torch.int32)
    for w in EDGES:
        tw = _i32(np.frombuffer(w.to_bytes(32, "little"), dtype="<u4")
                  .reshape(1, 8))
        args = _build.NttBlockArgs(
            src=x.data_ptr(), perm=perm.data_ptr(), tw=tw.data_ptr(),
            scale=None, dst=out.data_ptr(), lead=m * m, n=2, src_n=2,
            tw_rows=1, s0=0, k=1, lc=0, src_limbs=1, dst_limbs=1)
        assert hostlib.stark_ntt_block(ctypes.byref(args), None) == 0
        want = ntt.stage_plain(x, _i32(fp.ints_to_limbs([w])))
        np.testing.assert_array_equal(_np32(out), _np32(want))


def test_host_ntt_passes_plan():
    """Launches a transform: one pass up to 2^10 points, two to 2^20
    (balanced: 10 + 10, 7 + 6), a block C = 2 sub-transforms after the
    first pass while its tile stays within 1,024 points."""
    assert ntt.passes(6, 64) == [(0, 6, 0)]
    assert ntt.passes(13, 1 << 13) == [(0, 7, 0), (7, 6, 1)]
    assert ntt.passes(16, 1 << 16) == [(0, 8, 0), (8, 8, 1)]
    assert ntt.passes(20, 1 << 20) == [(0, 10, 0), (10, 10, 0)]
    assert ntt.passes(21, 1 << 21) == [(0, 7, 0), (7, 7, 1), (14, 7, 1)]
    assert ntt.passes(1, 2) == [(0, 1, 0)]
    assert ntt.passes(11, 1 << 11) == [(0, 6, 0), (6, 5, 1)]


@pytest.mark.parametrize("fault", ["smem_over_limit", "n_not_pow2",
                                   "unaligned_src", "unaligned_tw",
                                   "pass_past_log2n", "tile_past_n",
                                   "short_twiddles", "perm_in_place",
                                   "in_place_two_layouts"])
def test_host_ntt_block_rejects_bad_arguments(hostlib, fault):
    src = torch.zeros((64, 16), dtype=torch.int32)
    dst = torch.zeros((64, 16), dtype=torch.int32)
    tw = torch.zeros((32, 8), dtype=torch.int32)
    perm = torch.arange(64, dtype=torch.int32)
    f = dict(src=src.data_ptr(), perm=None, tw=tw.data_ptr(), scale=None,
             dst=dst.data_ptr(), lead=1, n=64, src_n=64, tw_rows=32, s0=0,
             k=6, lc=0, src_limbs=1, dst_limbs=1)
    assert hostlib.stark_ntt_block(
        ctypes.byref(_build.NttBlockArgs(**f)), None) == 0
    big = dict(n=1 << 13, src_n=1 << 13, tw_rows=1 << 12)
    bad = {"smem_over_limit": dict(big, k=11, lc=1),    # 4,096 points
           "n_not_pow2": dict(n=48, src_n=48),
           "unaligned_src": dict(src=src.data_ptr() + 4),
           "unaligned_tw": dict(tw=tw.data_ptr() + 8),
           "pass_past_log2n": dict(s0=1),
           "tile_past_n": dict(k=5, lc=2),
           "short_twiddles": dict(tw_rows=16),
           "perm_in_place": dict(perm=perm.data_ptr(), dst=src.data_ptr()),
           "in_place_two_layouts": dict(dst=src.data_ptr(), dst_limbs=0),
           }[fault]
    assert hostlib.stark_ntt_block(
        ctypes.byref(_build.NttBlockArgs(**{**f, **bad})), None) != 0


@pytest.mark.parametrize("fault", ["half_not_pow2", "half_too_big",
                                   "twiddle_past_table", "perm_in_place",
                                   "src_n_without_perm", "unaligned"])
def test_host_ntt_stage_rejects_bad_arguments(hostlib, fault):
    src = torch.zeros((8, 16), dtype=torch.int32)
    dst = torch.zeros((8, 16), dtype=torch.int32)
    tw = torch.zeros((4, 8), dtype=torch.int32)
    perm = torch.arange(8, dtype=torch.int32)
    f = dict(src=src.data_ptr(), perm=None, tw=tw.data_ptr(), scale=None,
             dst=dst.data_ptr(), lead=1, n=8, src_n=8, half=2, tw_rows=4,
             tw_stride=2, tw_off=0, src_limbs=1, dst_limbs=1)
    assert hostlib.stark_ntt_stage(
        ctypes.byref(_build.NttStageArgs(**f)), None) == 0
    bad = {"half_not_pow2": dict(half=3), "half_too_big": dict(half=8),
           "twiddle_past_table": dict(tw_off=2),
           "perm_in_place": dict(perm=perm.data_ptr(), dst=src.data_ptr()),
           "src_n_without_perm": dict(src_n=16),
           "unaligned": dict(dst=dst.data_ptr() + 4)}[fault]
    assert hostlib.stark_ntt_stage(
        ctypes.byref(_build.NttStageArgs(**{**f, **bad})), None) != 0


# ---------------------------------------------------------------------------
# the MiMC scan kernel
# ---------------------------------------------------------------------------

MIMC_INPUTS = [0, 1, 3, P - 1, P, 2**256 - 1, 2**255 + 12345, 7 * 2**200,
               P + 1, 2**256 - 2**32, 2**255]


def _scan(hostlib, x, consts, steps, power=3):
    out = torch.full_like(x, 7)
    assert hostlib.stark_mimc_scan(x.data_ptr(), consts.data_ptr(),
                                   consts.shape[0], max(steps - 1, 0), power,
                                   out.data_ptr(), x.shape[0], None) == 0
    return out


@pytest.mark.parametrize("power", [3, 2])
@pytest.mark.parametrize("steps", [0, 1, 2, 70, 64, 65, 66, 130])
def test_host_mimc_scan(hostlib, power, steps):
    """The scan kernel's per-input body, built by g++, around the wrap of
    64 constants: equal to the plain version on raw inputs (0, p - 1, p,
    p + 1, 2^256 - 1, carry patterns) with a wide limb in one input, for a
    family of 64 constants and for one of 80 whose constant 65 (read from
    67 steps on) has a wide limb, which makes every output all ones."""
    x = _i32(fp.ints_to_limbs(MIMC_INPUTS))
    x[6, 15] = 0x12345                                  # a wide limb
    c = _i32(mimc.round_constants_mimc(80))
    c[65, 3] = 0x1FFFF
    for consts in (c[:64], c):
        np.testing.assert_array_equal(
            _scan(hostlib, x, consts, steps, power).numpy(),
            mimc.mimc_plain(x, steps, consts, power).numpy())


def test_host_mimc_scan_rejects_bad_arguments(hostlib):
    x = _i32(fp.ints_to_limbs([1, 2]))
    out = torch.empty_like(x)
    args = [x.data_ptr(), x.data_ptr(), 2, 3, 3, out.data_ptr(), 2, None]
    assert hostlib.stark_mimc_scan(*args) == 0
    for at, bad in ((4, 4), (2, 0), (3, -1)):         # power, k, rounds
        assert hostlib.stark_mimc_scan(
            *args[:at], bad, *args[at + 1:]) != 0
    assert hostlib.stark_mimc_scan(x.data_ptr() + 4, *args[1:]) != 0


def test_host_mimc_scan_known_output_8192(hostlib):
    """Input 3 through the default family's 8,191 rounds: the known output
    (mimc_host)."""
    x = _i32(fp.ints_to_limbs([3]))
    out = _scan(hostlib, x, _i32(mimc.round_constants_mimc(64)), 8192)
    assert fp.limbs_to_int(_np32(out)[0]) == mimc.mimc_host(3, 8192)


@pytest.mark.parametrize("k", [7168, 7169, 8192])
def test_host_mimc_scan_constants_past_shared_memory(hostlib, k):
    """A family of k constants, every one read and the first ones again
    (k + 3 steps): up to 7,168 staged as in shared memory, more read from
    their rows; equal to mimc_host."""
    ints = [(i ** 7) ^ 42 for i in range(k)]
    vals = [3, P - 1, 2**256 - 1]
    out = _scan(hostlib, _i32(fp.ints_to_limbs(vals)),
                _i32(mimc.round_constants_mimc(k)), k + 3)
    assert [fp.limbs_to_int(r) for r in _np32(out)] == [
        mimc.mimc_host(v, k + 3, ints) for v in vals]


def test_host_mimc_scan_wide_constant_past_shared_memory(hostlib):
    """8,192 constants with a wide limb in constant 8,000: all ones once a
    round reads it (8,002 steps), the exact output while none does
    (8,001)."""
    consts = _i32(mimc.round_constants_mimc(8192))
    consts[8000, 0] = 0x10000
    ints = [(i ** 7) ^ 42 for i in range(8192)]
    x = _i32(fp.ints_to_limbs([5]))
    out = _scan(hostlib, x, consts, 8001)
    assert fp.limbs_to_int(_np32(out)[0]) == mimc.mimc_host(5, 8001, ints)
    assert (_np32(_scan(hostlib, x, consts, 8002)) == 0xFFFFFFFF).all()


# ---------------------------------------------------------------------------
# the narrow hashes: hash_words and the chain mode
# ---------------------------------------------------------------------------

def _blake2s_words(words, nbytes):
    """hashlib's digest of each message's first nbytes bytes, as LE words."""
    w = np.ascontiguousarray(words.numpy()).view(np.uint32)
    rows = w.reshape(-1, w.shape[-1])
    out = [np.frombuffer(hashlib.blake2s(r.astype("<u4").tobytes()[:nbytes])
                         .digest(), dtype="<u4") for r in rows]
    return np.stack(out).reshape(w.shape[:-1] + (8,))


@pytest.mark.parametrize("nbytes,W,lead,dirty", [
    (32, 8, (), False), (33, 9, (5,), False), (64, 16, (3, 4), False),
    (192, 48, (5,), False), (32, 8, (3, 4), False), (192, 48, (), False),
    (33, 9, (3, 4), True), (32, 10, (5,), True)])
def test_host_hash_words(hostlib, nbytes, W, lead, dirty):
    """The entry point built by g++ against hashlib and the plain version,
    word for word, at the protocol's lengths and three leading shapes; with
    `dirty` the bits past nbytes are not zero (a 33-byte message's last
    word, two words past a 32-byte one): it hashes them as the plain
    version does."""
    rng = np.random.RandomState(nbytes + W + len(lead))
    words = _words(rng, lead + (W,))
    flat = words.view(-1, W)
    if not dirty:                       # zeros past nbytes, as callers pad
        byte = np.arange(4 * W).reshape(W, 4)
        mask = ((byte < nbytes) * (0xFF << (8 * np.arange(4)))).sum(1)
        flat &= _i32(mask.astype(np.uint32))
    got = blake2s_cuda.hash_words(words, nbytes, lib=hostlib)
    assert got.shape == lead + (8,)
    np.testing.assert_array_equal(
        got.numpy(), blake2s.hash_words_plain(words, nbytes).numpy())
    if not dirty:
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      _blake2s_words(words, nbytes))


@pytest.mark.parametrize("links", [0, 1, 9])
def test_host_hash_chain(hostlib, links):
    """The chain mode against prg.chain_entries' plain loop on [2, 6]
    seeds: the raw seed first, then `links` links."""
    seeds = _words(np.random.RandomState(links), (2, 6, 8))
    got = blake2s_cuda.chain_entries(seeds, links, lib=hostlib)
    assert got.shape == (2, 6, links + 1, 8)
    np.testing.assert_array_equal(
        got.numpy(), prg.chain_entries_plain(seeds, links + 1).numpy())
    assert torch.equal(got[..., 0, :], seeds)


@pytest.mark.parametrize("fault", ["nbytes_past_words", "int64",
                                   "negative_links", "chain_width",
                                   "cpu_without_a_host_build"])
def test_host_hash_wrapper_rejects(hostlib, fault):
    """The wrapper raises on what the kernel does not take, before any
    launch; the entry point refuses the same operands on its own."""
    w = torch.zeros((3, 9), dtype=torch.int32)
    before = dict(blake2s_cuda.launches)
    call = {"nbytes_past_words": lambda: blake2s_cuda.hash_words(
                w, 37, lib=hostlib),
            "int64": lambda: blake2s_cuda.hash_words(
                w.to(torch.int64), 33, lib=hostlib),
            "negative_links": lambda: blake2s_cuda.chain_entries(
                w[:, :8], -1, lib=hostlib),
            "chain_width": lambda: blake2s_cuda.chain_entries(
                w, 2, lib=hostlib),
            "cpu_without_a_host_build": lambda: blake2s_cuda.hash_words(
                w, 33)}[fault]
    with pytest.raises((TypeError, ValueError)):
        call()
    assert blake2s_cuda.launches == before
    out = torch.empty((3, 8), dtype=torch.int32)
    ok = dict(src=w.data_ptr(), dst=out.data_ptr(), n=3, words=9, nbytes=33,
              chain=0, links=0)
    bad = {"nbytes_past_words": dict(nbytes=37), "int64": dict(words=0),
           "negative_links": dict(words=8, nbytes=32, chain=1, links=-1),
           "chain_width": dict(chain=1, links=2),
           "cpu_without_a_host_build": dict(dst=out.data_ptr() + 4)}[fault]
    for f, rc in ((ok, 0), ({**ok, **bad}, 1)):
        assert hostlib.stark_hash_words(
            ctypes.byref(_build.HashArgs(**f)), None) == rc


def test_host_hash_counts_launches_and_skips_empty_batches(hostlib):
    before = dict(blake2s_cuda.launches)
    assert blake2s_cuda.hash_words(torch.zeros((0, 16), dtype=torch.int32),
                                   64, lib=hostlib).shape == (0, 8)
    assert blake2s_cuda.chain_entries(torch.zeros((2, 0, 8),
                                                  dtype=torch.int32), 3,
                                      lib=hostlib).shape == (2, 0, 4, 8)
    assert blake2s_cuda.launches == before
    blake2s_cuda.hash_words(torch.zeros((2, 16), dtype=torch.int32), 64,
                            lib=hostlib)
    blake2s_cuda.chain_entries(torch.zeros((2, 8), dtype=torch.int32), 3,
                               lib=hostlib)
    assert blake2s_cuda.launches == {
        "hash_words": before["hash_words"] + 1,
        "hash_chain": before["hash_chain"] + 1}


def test_plain_hashes_and_walks_do_not_reach_the_dispatch(monkeypatch):
    """The plain walks, the plain chain and the plain hash hash through
    hash_words_plain: with the dispatch broken they still run; a tensor on
    neither the CPU nor the card gets no fallback."""
    def broken(*args):
        raise AssertionError("a plain version called the hash's dispatch")

    monkeypatch.setattr(blake2s, "hash_words", broken)
    monkeypatch.setattr(blake2s_cuda, "hash_words", broken)
    monkeypatch.setattr(blake2s_cuda, "chain_entries", broken)
    rng = np.random.RandomState(3)
    val, sib = _words(rng, (2, 4, 8)), _words(rng, (2, 4, 8))
    wit = _words(rng, (2, 4, 5, 8))
    ti = _start_index(8, 5).reshape(2, 4)
    assert merkle_cuda.walk_leaf_levels_plain(val, sib, wit, ti,
                                              3).shape == (2, 4, 8)
    assert merkle_cuda.walk_branches_plain(
        val, sib, wit, ti, torch.full((2, 4), 5, dtype=torch.int32)
    ).shape == (2, 4, 8)
    res, ok = merkle_cuda.walk_quads_plain(val, sib, wit, ti, 2)
    assert res.shape == (2, 1, 8) and ok.shape == (2, 1)
    assert prg.chain_entries_plain(val, 3).shape == (2, 4, 3, 8)
    monkeypatch.undo()
    meta = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    for call in (lambda: blake2s.hash_words(meta, 32),
                 lambda: prg.chain_entries(meta, 3)):
        with pytest.raises(ValueError):
            call()
