"""FRI row interpolation: the even/odd-split evaluation.

Only the production form is ported (it is the plain version of the row
kernel, ops/fri_cuda.py); the JAX package's barycentric cross-check forms are
used by its tests alone.  Being a plain version, it multiplies through
field_cuda.mul_mod_plain on either device, never through the multiply kernel.
"""

from __future__ import annotations

import torch

from . import field as F
from .field_cuda import mul_mod_plain as _mul


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
