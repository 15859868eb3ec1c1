"""Batched 4-point interpolation and evaluation for FRI rows.

Counterpart of the JAX package's ops/quartic.py (reference:
src/utils.rs:103-120, 196-244, multi_interp_4 and eval_quartic): every row
group of every proof interpolates in lockstep.  All arithmetic is mod-p
homomorphic, so raw (unreduced) row values from the proof bytes are
accepted directly; outputs are canonical.

Two kinds of function live here:

  * eval4_even_odd, the production form: the plain version of the row
    kernel (ops/fri_cuda.py).  Being a plain version, it multiplies through
    field_cuda.mul_mod_plain on either device, never through the multiply
    kernel.
  * the cross-check forms -- the coefficient form (interp4, eval_quartic),
    the inversion-free barycentric form (eval4_inv_free) and the barycentric
    form with one shared inversion (eval_interp4_nodes, split as
    interp4_nodes_pre / interp4_nodes_finish).  They are independent
    formulations of the same row value, plain torch whose products go
    through field.mul_mod: on the card the element-wise multiply kernel
    (kernel E), on the CPU its plain version.
"""

from __future__ import annotations

import torch

from . import field as F
from .field_cuda import mul_mod_plain as _mul


def interp4(xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Batched 4-point Lagrange interpolation.

    xs: [..., G, 4, 16] x-coordinates (canonical), ys: [..., G, 4, 16] values
    (may be raw/unreduced).  Returns [..., G, 4, 16] coefficient vectors
    (constant-first), canonical -- matching multi_interp_4's output mod p.
    Repeated xs give a zero denominator, which the shared inversion maps
    to 0, as the reference's multi_inv does.
    """
    x0, x1, x2, x3 = (xs[..., i, :] for i in range(4))
    x01 = F.mul_mod(x0, x1)
    x02 = F.mul_mod(x0, x2)
    x03 = F.mul_mod(x0, x3)
    x12 = F.mul_mod(x1, x2)
    x13 = F.mul_mod(x1, x3)
    x23 = F.mul_mod(x2, x3)
    x123 = F.mul_mod(x12, x3)
    x023 = F.mul_mod(x02, x3)
    x013 = F.mul_mod(x01, x3)
    x012 = F.mul_mod(x01, x2)

    one = F.const(1, xs.device).expand(x0.shape)

    def eq(c0, q1a, q1b, q1c, l1, l2, l3):
        # [c0neg, q1a+q1b+q1c, -(l1+l2+l3), 1]   (utils.rs:204-217 pattern)
        return torch.stack([
            F.neg_mod(c0),
            F.add_mod(F.add_mod(q1a, q1b), q1c),
            F.neg_mod(F.add_mod(F.add_mod(l1, l2), l3)),
            one,
        ], dim=-2)                                    # [..., 4(coef), 16]

    eq0 = eq(x123, x12, x13, x23, x1, x2, x3)
    eq1 = eq(x023, x02, x03, x23, x0, x2, x3)
    eq2 = eq(x013, x01, x03, x13, x0, x1, x3)
    eq3 = eq(x012, x01, x02, x12, x0, x1, x2)
    eqs = torch.stack([eq0, eq1, eq2, eq3], dim=-3)   # [..., 4(i), 4(j), 16]

    e = eval_quartic(eqs, xs)                         # [..., G, 4, 16] e_i = eq_i(x_i)

    # one shared inversion across the whole (G*4) batch of each leading
    # index, like the reference's single multi_inv over all groups
    # (utils.rs:228)
    lead = tuple(e.shape[:-3])
    inv_e = F.batch_inv(e.reshape(lead + (-1, 16))).reshape(e.shape)

    iy = F.mul_mod(ys, inv_e)                         # [..., G, 4, 16]
    terms = F.mul_mod(eqs, iy[..., :, None, :])       # [..., 4(i), 4(j), 16]
    return F._sum_mod(terms.movedim(-3, -2), axis=-2)  # sum over i -> [..., 4(j), 16]


def _hit(d: torch.Tensor, ys: torch.Tensor) -> tuple:
    """(any_hit [..., G] bool, the raw y of the hit node [..., G, 16]) for
    the differences d = sx - x_i [..., G, 4, 16]: the nodes are distinct, so
    at most one lane of a group is 0, and its y is picked by a sum (the JAX
    package's select; a sum over int32 is int64 here, so it is cast back)."""
    hit = (d == 0).all(dim=-1)                        # [..., G, 4]
    y_sel = torch.where(hit[..., None], ys, 0).sum(dim=-2).to(torch.int32)
    return hit.any(dim=-1), y_sel


def eval4_inv_free(nodes: torch.Tensor, x1cb_inv: torch.Tensor,
                   winv: torch.Tensor, ys: torch.Tensor,
                   sx: torch.Tensor) -> torch.Tensor:
    """Inversion-FREE barycentric quartic evaluation for FRI's structured
    nodes x_i = q_i * x1.

    The only true denominator in the barycentric form is x1^3 (the shared
    factor of the weights w_i = x1^3 * wconst_i): since x1 is a known power
    of G2, its inverse cube is a GATHER from the same power table the nodes
    come from -- so the caller passes x1cb_inv = G2^(-3y) and winv[4, 16] =
    host-precomputed inverses of the wconst_i, and no field inversion
    remains:

        P(sx) = [ sum_i (y_i * winv_i) * prod_{j != i} (sx - x_j) ] / x1^3

    nodes: [..., G, 4, 16] canonical; x1cb_inv: [..., G, 16]; winv: [4, 16];
    ys: [..., G, 4, 16] raw rows; sx: [..., 16] (raw ok), broadcast over G.
    Returns [..., G, 16] canonical -- bit-identical to the reference's
    multi_interp_4 + eval_quartic value (src/utils.rs:196-244, 103-120).
    """
    d = F.sub_mod(F.canon(sx)[..., None, None, :], nodes)  # [..., G, 4, 16]
    d01 = F.mul_mod(d[..., 0, :], d[..., 1, :])
    d23 = F.mul_mod(d[..., 2, :], d[..., 3, :])
    others = torch.stack([
        F.mul_mod(d[..., 1, :], d23), F.mul_mod(d[..., 0, :], d23),
        F.mul_mod(d01, d[..., 3, :]), F.mul_mod(d01, d[..., 2, :]),
    ], dim=-2)                                           # prod_{j != i} d_j
    # the 4 barycentric terms (y_i winv_i) prod_{j != i} d_j, summed by
    # add_mod (the JAX package folds their products in one mul_sum_mod
    # reduction; every product here is field.mul_mod, and the canonical sum
    # is the same value)
    terms = F.mul_mod(F.mul_mod(ys, winv), others)      # [..., G, 4, 16]
    lhs = F.mul_mod(F._sum_mod(terms), x1cb_inv)

    # sx coinciding with a node: the interpolant's value is that node's y.
    # Select the raw y first, then canonicalize once per GROUP
    any_hit, y_sel = _hit(d, ys)
    return torch.where(any_hit[..., None], F.canon(y_sel), lhs)


def eval4_even_odd(x1_inv: torch.Tensor, x1sq_inv: torch.Tensor,
                   ys: torch.Tensor, sx: torch.Tensor,
                   ginv: torch.Tensor, inv4: torch.Tensor) -> torch.Tensor:
    """Even/odd-split evaluation of the FRI row interpolant (7 multiplies per
    row group, Horner in sx^2/x1^2).

    The nodes are q_i * x1 with q = (1, g, g^2, g^3) the quartic roots of
    unity (stale-root quirk of the reference: identical at every level), and
    g^2 = -1, so the interpolating cubic splits into even/odd parts that are
    LINEAR in z^2:

        P(z) = A(z^2) + z * B(z^2),   A(t) = (y0 + y2)/2,  A(-t) = (y1 + y3)/2
        B(t) = (y0 - y2)/(2 x1),      B(-t) = (y1 - y3)/(2 g x1),  t = x1^2

    which solves to (with c1 = (y1 - y3) * g^{-1}):

        4 * P(sx) = (y0+y1+y2+y3)
                  + ((y0+y2) - (y1+y3)) * (sx^2 / x1^2)
                  + ((y0-y2) + c1) * (sx / x1)
                  + ((y0-y2) - c1) * (sx / x1) * (sx^2 / x1^2)

    The divisions are all by powers of x1 = G2^e -- gathers from the power
    table (x1_inv = G2^{-e}, x1sq_inv = G2^{-2e}) -- so there is NO field
    inversion, and the form is polynomial in sx (exact where sx hits a node).
    Bit-identical to the reference's multi_interp_4 + eval_quartic value
    (src/utils.rs:196-244, 103-120): same polynomial, evaluated mod p.

    x1_inv/x1sq_inv: [..., G, 16] canonical; ys: [..., G, 4, 16] raw rows;
    sx: [..., 16] raw (broadcast over G); ginv/inv4: [16] constants
    g^{-1} = g^3 and 4^{-1} mod p.  Returns [..., G, 16] canonical.
    """
    sxc = F.canon(sx)
    s2 = _mul(sxc, sxc)                                   # shared per level
    y = F.canon(ys)
    y0, y1, y2, y3 = (y[..., i, :] for i in range(4))
    s02, s13 = F.add_mod(y0, y2), F.add_mod(y1, y3)
    d02 = F.sub_mod(y0, y2)
    c1 = _mul(F.sub_mod(y1, y3), ginv)
    sa = F.add_mod(s02, s13)
    da = F.sub_mod(s02, s13)
    e = F.add_mod(d02, c1)
    f = F.sub_mod(d02, c1)
    st = _mul(s2[..., None, :], x1sq_inv)            # v = sx^2 / x1^2
    sxx = _mul(sxc[..., None, :], x1_inv)            # u = sx / x1
    # Horner in v: e*u + f*u*v == (e + f*v)*u -- one full multiply saved
    efv = F.add_mod(e, _mul(f, st))
    s = F.mul_sum_mod([(da, st), (efv, sxx)], extra=[sa])
    return _mul(s, inv4)


def eval_interp4_nodes(nodes: torch.Tensor, x1cb: torch.Tensor,
                       wconsts: torch.Tensor, ys: torch.Tensor,
                       sx: torch.Tensor) -> torch.Tensor:
    """Barycentric quartic evaluation for FRI's structured nodes x_i = q_i*x1.

    nodes: [..., G, 4, 16] canonical (gathered from the power table);
    x1cb: [..., G, 16] = x1^3; wconsts: [4, 16] host constants
    prod_{j!=i}(q_i - q_j); ys: [..., G, 4, 16] raw rows; sx: [..., 16].
    Returns [..., G, 16] canonical -- identical to the reference's
    multi_interp_4 + eval_quartic value (src/utils.rs:196-244, 103-120),
    exploiting w_i = prod_{j!=i}(x_i - x_j) = x1^3 * wconst_i.  One
    inversion of the groups' totals along G (field.batch_inv).
    """
    pre = interp4_nodes_pre(nodes, x1cb, wconsts, ys, sx)
    inv_total = F.batch_inv(pre["total"])
    return interp4_nodes_finish(pre, inv_total)


def interp4_nodes_pre(nodes, x1cb, wconsts, ys, sx) -> dict:
    """Everything of eval_interp4_nodes before the inversion (so callers can
    merge the batch inversion with other inverses into one Fermat chain).
    Returns {"total" [..., G, 16] (the values to invert), "pre_lhs"
    [..., G, 16], "any_hit" [..., G] bool, "y_hit" [..., G, 16]}."""
    d = F.sub_mod(F.canon(sx)[..., None, None, :], nodes)
    num = F.mul_mod_lazy(F.mul_mod_lazy(d[..., 0, :], d[..., 1, :]),
                         F.mul_mod_lazy(d[..., 2, :], d[..., 3, :]))
    w = F.mul_mod_lazy(wconsts, x1cb[..., None, :])      # [..., G, 4, 16]
    t = F.mul_mod_lazy(d, w)                              # t_i = d_i * w_i

    # one inversion per GROUP: 1/t_i = (prod_{j!=i} t_j) * inv(prod_j t_j)
    t0, t1, t2, t3 = (t[..., i, :] for i in range(4))
    p01 = F.mul_mod_lazy(t0, t1)
    p23 = F.mul_mod_lazy(t2, t3)
    total = F.mul_mod(p01, p23)                           # [..., G, 16]
    others = torch.stack([F.mul_mod_lazy(t1, p23), F.mul_mod_lazy(t0, p23),
                          F.mul_mod_lazy(p01, t3), F.mul_mod_lazy(p01, t2)],
                         dim=-2)
    terms = F.mul_mod(ys, others)
    ssum = F.add_mod(F.add_mod(terms[..., 0, :], terms[..., 1, :]),
                     F.add_mod(terms[..., 2, :], terms[..., 3, :]))
    pre_lhs = F.mul_mod_lazy(num, ssum)

    any_hit, y_hit = _hit(d, F.canon(ys))
    return {"total": total, "pre_lhs": pre_lhs, "any_hit": any_hit,
            "y_hit": y_hit}


def interp4_nodes_finish(pre: dict, inv_total: torch.Tensor) -> torch.Tensor:
    """eval_interp4_nodes after the inversion: inv_total [..., G, 16] the
    inverses of pre["total"]."""
    lhs = F.mul_mod(pre["pre_lhs"], inv_total)
    return torch.where(pre["any_hit"][..., None], pre["y_hit"], lhs)


def eval_quartic(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """coeffs[..., 4, 16] (constant-first), x [..., 16] -> [..., 16] canonical.

    Mirrors eval_quartic (utils.rs:103-120): c0 + c1*x + c2*x^2 + c3*x^3 mod p.
    x may be raw/unreduced (the FRI special_x quirk).
    """
    xsq = F.mul_mod(x, x)
    xcb = F.mul_mod(xsq, x)
    t0 = F.canon(coeffs[..., 0, :])
    t1 = F.mul_mod(coeffs[..., 1, :], x)
    t2 = F.mul_mod(coeffs[..., 2, :], xsq)
    t3 = F.mul_mod(coeffs[..., 3, :], xcb)
    return F.add_mod(F.add_mod(t0, t1), F.add_mod(t2, t3))
