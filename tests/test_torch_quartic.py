"""Port's ops/quartic.py cross-check forms against the JAX package's
namesakes and the oracle (multi_interp_4 + eval_quartic), tolerance 0.

The same numpy inputs go to both packages: a [2, 3] leading batch of G row
groups whose nodes are gathered from the power table of a small family,
raw rows holding 0, p - 1, p, p + 1 and 2^256 - 1, special_x values that are
raw (>= p), that land on a group's first and second node (one of them
only after canonicalization: p + 1 on the node G2^0 = 1), and, for interp4,
a group with a repeated x.  The JAX side runs in one jitted call (its two
Fermat inversion chains cost most of this file's time, about a minute)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import oracle
from stark_verifier_tpu.ops import quartic as JQ
from stark_verifier_tpu_torch import fp
from stark_verifier_tpu_torch.config import StarkConfig, cached_tables
from stark_verifier_tpu_torch.ops import field as F, quartic as Q

torch.set_num_threads(1)
P = fp.MODULUS
LEAD, G = (2, 3), 2
HITS = {(0, 1): (1, 1), (1, 2): (0, 0), (1, 0): (1, 0)}   # (b, l) -> (g, node)
REPEAT = (1, 2, 1)                                       # interp4: x1 := x0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def _n(t):
    return np.ascontiguousarray(t.numpy()).view(np.uint32)


def _ints(a):
    return [fp.limbs_to_int(r) for r in np.asarray(a).reshape(-1, 16)]


def _limbs(vals, shape):
    return fp.ints_to_limbs(vals).reshape(shape + (16,))


@pytest.fixture(scope="module")
def case():
    tables = cached_tables(StarkConfig(log_steps=9))
    rows = tables.g2_powers.shape[0]
    mask = rows - 1
    rng = np.random.RandomState(2024)
    e1 = rng.randint(0, rows, LEAD + (G,)).astype(np.int64)
    e1[1, 0, 1] = 0                                      # x1 = 1
    idx = (e1[..., None] + np.arange(4) * (rows // 4)) & mask
    nodes = tables.g2_powers[idx]                        # [2, 3, G, 4, 16]
    x1cb = tables.g2_powers[(3 * e1) & mask]
    x1cb_inv = tables.g2_powers[(-3 * e1) & mask]
    ys_int = [int.from_bytes(rng.bytes(32), "little")
              for _ in range(int(np.prod(LEAD)) * G * 4)]
    ys_int[:6] = [0, P - 1, P, P + 1, 2**256 - 1, 2**256 - 1]
    ys_int[-3:] = [P, P + 1, 2**256 - 1]
    ys = _limbs(ys_int, LEAD + (G, 4))
    sx_int = [int.from_bytes(rng.bytes(32), "little") for _ in range(6)]
    sx_int[1] = 2**256 - 1                               # raw, >= p
    sx_int[4] = P + 12345                                # raw, >= p
    for (b, l), (g, k) in HITS.items():
        sx_int[b * LEAD[1] + l] = fp.limbs_to_int(nodes[b, l, g, k])
    sx_int[LEAD[1]] = P + 1                  # (1, 0): raw, on the node 1 = G2^0
    sx = _limbs(sx_int, LEAD)
    xs_rep = nodes.copy()
    xs_rep[REPEAT + (1,)] = xs_rep[REPEAT + (0,)]
    wconsts, winv = oracle.quartic_weight_consts(tables.G2, rows)

    def jax_side(nodes, x1cb, x1cb_inv, ys, sx, xs_rep):
        coeffs = JQ.interp4(xs_rep, ys)
        pre = JQ.interp4_nodes_pre(nodes, x1cb, wconsts, ys, sx)
        return {
            "interp4": coeffs,
            "eval_quartic": JQ.eval_quartic(coeffs, sx[..., None, :]),
            "eval4_inv_free": JQ.eval4_inv_free(nodes, x1cb_inv, winv, ys, sx),
            "eval_interp4_nodes": JQ.eval_interp4_nodes(nodes, x1cb, wconsts,
                                                        ys, sx),
            "pre": pre,
        }

    want = jax.tree_util.tree_map(np.asarray, jax.jit(jax_side)(
        *(jnp.asarray(a) for a in (nodes, x1cb, x1cb_inv, ys, sx, xs_rep))))
    # the oracle, group by group of each (proof, level)
    oracle_coeffs, oracle_vals = [], []
    for b in range(LEAD[0]):
        for l in range(LEAD[1]):
            for xs_np, out in ((xs_rep, oracle_coeffs), (nodes, None)):
                xs_l = _ints(xs_np[b, l])
                ys_l = _ints(ys[b, l])
                polys = oracle.multi_interp_4(xs_l, ys_l)
                if out is not None:
                    out += polys
                else:
                    s = sx_int[b * LEAD[1] + l]
                    oracle_vals += [oracle.eval_quartic(polys[4 * g:4 * g + 4], s)
                                    for g in range(G)]
    return {"nodes": nodes, "x1cb": x1cb, "x1cb_inv": x1cb_inv, "ys": ys,
            "ys_int": ys_int, "sx": sx, "sx_int": sx_int, "xs_rep": xs_rep,
            "wconsts": wconsts, "winv": winv, "want": want,
            "oracle_coeffs": oracle_coeffs, "oracle_vals": oracle_vals}


def _eval_rep_oracle(c):
    """The oracle's value of the interp4 coefficients at special_x."""
    out = []
    for i in range(int(np.prod(LEAD))):
        s = c["sx_int"][i]
        for g in range(G):
            k = (i * G + g) * 4
            out.append(oracle.eval_quartic(c["oracle_coeffs"][k:k + 4], s))
    return out


def test_interp4_and_eval_quartic(case):
    c = case
    coeffs = Q.interp4(_t(c["xs_rep"]), _t(c["ys"]))
    assert coeffs.shape == LEAD + (G, 4, 16)
    np.testing.assert_array_equal(_n(coeffs), c["want"]["interp4"])
    assert _ints(_n(coeffs)) == c["oracle_coeffs"]
    ev = Q.eval_quartic(coeffs, _t(c["sx"])[..., None, :])
    np.testing.assert_array_equal(_n(ev), c["want"]["eval_quartic"])
    assert _ints(_n(ev)) == _eval_rep_oracle(c)


def test_interp4_repeated_x_is_the_degenerate_answer(case):
    """A repeated x makes two denominators 0; batch_inv maps them to 0, so
    those two terms drop out (test_interp4_and_eval_quartic holds that
    answer against JAX and the oracle), and the other groups of the shared
    inversion are untouched."""
    c = case
    got = _n(Q.interp4(_t(c["xs_rep"]), _t(c["ys"])))
    clean = _n(Q.interp4(_t(c["nodes"]), _t(c["ys"])))
    b, l, g = REPEAT
    assert not np.array_equal(got[b, l, g], clean[b, l, g])
    keep = np.ones(LEAD + (G,), dtype=bool)
    keep[b, l, g] = False
    np.testing.assert_array_equal(got[keep], clean[keep])


def test_eval4_inv_free(case):
    c = case
    got = _n(Q.eval4_inv_free(_t(c["nodes"]), _t(c["x1cb_inv"]),
                              _t(c["winv"]), _t(c["ys"]), _t(c["sx"])))
    np.testing.assert_array_equal(got, c["want"]["eval4_inv_free"])
    assert _ints(got) == c["oracle_vals"]


def test_eval_interp4_nodes(case):
    c = case
    got = _n(Q.eval_interp4_nodes(_t(c["nodes"]), _t(c["x1cb"]),
                                  _t(c["wconsts"]), _t(c["ys"]), _t(c["sx"])))
    np.testing.assert_array_equal(got, c["want"]["eval_interp4_nodes"])
    assert _ints(got) == c["oracle_vals"]


def test_interp4_nodes_pre_and_finish(case):
    c = case
    pre = Q.interp4_nodes_pre(_t(c["nodes"]), _t(c["x1cb"]), _t(c["wconsts"]),
                              _t(c["ys"]), _t(c["sx"]))
    assert set(pre) == set(c["want"]["pre"])
    for key in ("total", "pre_lhs", "y_hit"):
        assert pre[key].dtype == torch.int32
        np.testing.assert_array_equal(_n(pre[key]), c["want"]["pre"][key])
    np.testing.assert_array_equal(pre["any_hit"].numpy(),
                                  c["want"]["pre"]["any_hit"])
    assert int(pre["any_hit"].sum()) == len(HITS)
    got = _n(Q.interp4_nodes_finish(pre, F.batch_inv(pre["total"])))
    np.testing.assert_array_equal(got, c["want"]["eval_interp4_nodes"])
    assert _ints(got) == c["oracle_vals"]


def test_node_collisions_return_the_nodes_canonical_y(case):
    """special_x on a node (the first, the second, and p + 1 on the node 1):
    every form returns that node's y, canonical, as the oracle does."""
    c = case
    forms = {
        "inv_free": Q.eval4_inv_free(_t(c["nodes"]), _t(c["x1cb_inv"]),
                                     _t(c["winv"]), _t(c["ys"]), _t(c["sx"])),
        "nodes": Q.eval_interp4_nodes(_t(c["nodes"]), _t(c["x1cb"]),
                                      _t(c["wconsts"]), _t(c["ys"]),
                                      _t(c["sx"])),
        "coefficients": Q.eval_quartic(Q.interp4(_t(c["nodes"]), _t(c["ys"])),
                                       _t(c["sx"])[..., None, :]),
    }
    for (b, l), (g, k) in HITS.items():
        y = c["ys_int"][((b * LEAD[1] + l) * G + g) * 4 + k] % P
        assert c["oracle_vals"][(b * LEAD[1] + l) * G + g] == y
        for name, out in forms.items():
            assert _ints(_n(out[b, l, g]))[0] == y, name
