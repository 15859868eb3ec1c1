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
import shutil
import subprocess

import numpy as np
import pytest
import torch

from stark_verifier_tpu_torch import _build, fp
from stark_verifier_tpu_torch.config import StarkConfig, cached_tables
from stark_verifier_tpu_torch.ops import (
    field as F, field_cuda, fri_cuda, merkle_cuda, spot_cuda)

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
         "-o", str(out), *map(str, _build.sources())], check=True)
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
    rc = hostlib.stark_walk_leaf_levels(
        val.data_ptr(), sib.data_ptr(), wit.data_ptr(), depth * 8,
        ti.data_ptr(), out.data_ptr(), vw, levels, n, None)
    assert rc == 0
    want = merkle_cuda.walk_leaf_levels_plain(val, sib, wit, ti, levels)
    np.testing.assert_array_equal(out.numpy(), want.numpy())


def test_host_walk_rejects_bad_width(hostlib):
    z = torch.zeros(64, dtype=torch.int32)
    assert hostlib.stark_walk_leaf_levels(
        z.data_ptr(), z.data_ptr(), z.data_ptr(), 8, z.data_ptr(),
        z.data_ptr(), 16, 1, 1, None) != 0


@pytest.mark.parametrize("levels", [3, 11])
def test_host_chain_levels_strided_view(hostlib, levels):
    """The verifier hands the chain kernel a level slice of one branch in
    four: a strided view with a storage offset."""
    rng = np.random.RandomState(levels)
    b, q, depth = 3, 5, levels + 2
    wit4 = _words(rng, (b, q, 4, depth, 8))
    view = wit4[:, :, 0, 1:1 + levels, :]
    h = _words(rng, (b, q, 8))
    ti = _i32(rng.randint(8, 1 << 20, (b, q)).astype(np.uint32))
    stride = merkle_cuda._witness_stride(view, 2, levels)
    assert stride == 4 * depth * 8
    out = torch.empty((b, q, 8), dtype=torch.int32)
    rc = hostlib.stark_chain_levels(
        h.data_ptr(), view.data_ptr(), stride, ti.data_ptr(), out.data_ptr(),
        levels, b * q, None)
    assert rc == 0
    want = merkle_cuda.chain_levels_plain(h, view, ti, levels)
    np.testing.assert_array_equal(out.numpy(), want.numpy())


def _limbs(vals):
    return _i32(fp.ints_to_limbs(vals))


def _special(rng, n):
    vals = [0, 1, P - 1, P, P + 1, 2**256 - 1, 2**256 - 2**32, P - 2]
    vals += [int.from_bytes(rng.bytes(32), "big") for _ in range(n - len(vals))]
    return vals[:n]


def test_host_eval4_rows(hostlib):
    rng = np.random.RandomState(5)
    tables = cached_tables(StarkConfig(log_steps=9))
    g2t = _i32(tables.g2_powers)
    b, g = 3, 8
    e1 = torch.from_numpy(rng.randint(0, 4096, (b, g)).astype(np.int64))
    x1_inv = g2t[(-e1) & 4095].contiguous()
    x1sq_inv = g2t[(-2 * e1) & 4095].contiguous()
    ys = F.limbs_to_words_be(
        _limbs(_special(rng, b * g * 4)).reshape(b, g, 4, 16)).contiguous()
    sx = _limbs([2**256 - 1, P + 5, int.from_bytes(rng.bytes(32), "big")])
    want = fri_cuda.eval4_rows_plain(x1_inv, x1sq_inv, ys, sx,
                                     tables.quartic_ginv, tables.inv4)
    out = torch.empty((b, g, 8), dtype=torch.int32)
    rc = hostlib.stark_eval4_rows(
        ys.data_ptr(), sx.data_ptr(), x1_inv.data_ptr(),
        x1sq_inv.data_ptr(), fri_cuda._limbs_to_u32x8(tables.quartic_ginv),
        fri_cuda._limbs_to_u32x8(tables.inv4), g, out.data_ptr(), b * g, None)
    assert rc == 0
    np.testing.assert_array_equal(out.numpy(), want.numpy())


@pytest.mark.parametrize("power", [3, 2])
def test_host_spot_checks(hostlib, power):
    rng = np.random.RandomState(7 + power)
    b, g = 3, 9
    raw5 = _limbs(_special(rng, b * g * 5)).reshape(b, g, 5, 16).clone()
    tab5 = F.canon(_limbs(_special(rng, b * g * 5))).reshape(b, g, 5, 16)
    ks4 = _limbs([2**256 - 1, P, 0, int.from_bytes(rng.bytes(32), "big")]
                 + _special(rng, 8)).reshape(b, 1, 4, 16)
    ic1 = F.canon(_limbs(_special(rng, b))).reshape(b, 1, 16)
    ic0 = F.canon(_limbs(list(reversed(_special(rng, b))))).reshape(b, 1, 16)
    # make each family hold somewhere: a canonical right-hand side is a valid
    # raw encoding of itself
    p, d, bb = (F.canon(raw5[..., i, :]) for i in (0, 2, 3))
    x, xs, z, z2, k = (tab5[..., i, :] for i in range(5))
    p_pow = [(F.sqr_mod(p), p)] if power == 3 else [(p, p)]
    raw5[0, 0, 1] = F.mul_sum_mod(p_pow + [(z, d)], extra=[k])[0, 0]
    raw5[1, 2, 4] = F.mul_sum_mod(
        [(ks4[..., 0, :], p), (ks4[..., 1, :], F.mul_mod(p, xs)),
         (ks4[..., 2, :], bb), (ks4[..., 3, :], F.mul_mod(bb, xs))],
        extra=[d])[1, 2]
    want = spot_cuda.spot_checks_plain(raw5, tab5, ks4, ic1, ic0, power)
    assert want[0, 0, 0] and want[1, 2, 2] and not want.all()
    raw5, tab5 = raw5.contiguous(), tab5.contiguous()
    ks4c, ic1c, ic0c = ks4.contiguous(), ic1.contiguous(), ic0.contiguous()
    bits = torch.empty((b, g), dtype=torch.int32)
    rc = hostlib.stark_spot_checks(
        raw5.data_ptr(), tab5.data_ptr(), ks4c.data_ptr(), ic1c.data_ptr(),
        ic0c.data_ptr(), g, power, bits.data_ptr(), b * g, None)
    assert rc == 0
    got = torch.stack([(bits & 1) != 0, (bits & 2) != 0, (bits & 4) != 0], -1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_host_spot_boundary_holds(hostlib):
    """A position whose boundary constraint holds sets bit 1 only."""
    rng = np.random.RandomState(3)
    raw5 = _limbs(_special(rng, 10)).reshape(2, 5, 16).clone()
    tab5 = F.canon(_limbs(_special(rng, 10))).reshape(2, 5, 16)
    ks4 = _limbs(_special(rng, 4)).reshape(1, 4, 16)
    ic1 = F.canon(_limbs([P - 3])).reshape(1, 16)
    ic0 = F.canon(_limbs([12345])).reshape(1, 16)
    bb = F.canon(raw5[..., 3, :])
    raw5[1, 0] = F.mul_sum_mod([(bb, tab5[..., 3, :]), (ic1, tab5[..., 0, :])],
                               extra=[ic0.expand(2, 16)])[1]
    want = spot_cuda.spot_checks_plain(raw5, tab5, ks4, ic1, ic0)
    assert want[1, 1]
    bits = torch.empty(2, dtype=torch.int32)
    rc = hostlib.stark_spot_checks(
        raw5.contiguous().data_ptr(), tab5.contiguous().data_ptr(),
        ks4.data_ptr(), ic1.data_ptr(), ic0.data_ptr(), 2, 3,
        bits.data_ptr(), 2, None)
    assert rc == 0
    got = torch.stack([(bits & 1) != 0, (bits & 2) != 0, (bits & 4) != 0], -1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


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
    rc = hostlib.stark_walk_branches(
        val.data_ptr(), sib.data_ptr(), vw, vw, wit.data_ptr(), max_depth * 8,
        ti.data_ptr(), depth.data_ptr(), max_depth, out.data_ptr(), n, None)
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
    rc = hostlib.stark_walk_branches(
        val.data_ptr(), sib.data_ptr(), 24, 8, padded.data_ptr(),
        (depth + 1) * 8, ti.data_ptr(), d.data_ptr(), depth + 1,
        out.data_ptr(), n, None)
    assert rc == 0
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    assert hostlib.stark_walk_branches(
        val.data_ptr(), sib.data_ptr(), 4, 8, padded.data_ptr(), 32,
        ti.data_ptr(), d.data_ptr(), 4, out.data_ptr(), n, None) != 0
