"""Constraint spot checks on the card: spot_checks (kernel D) with its plain
version.

Counterpart of the JAX package's ops/spot_pallas.py.  One kernel
(csrc/spot_checks.cu) evaluates all three per-position constraint families of
verify_mimc_proof (reference verifier: src/main.rs:163-192):

  transition   P(g1 x) == P(x)^power + K(x) + Z(x) D(x)
  boundary     P(x)    == B(x) Z2(x) + I1 x + I0
  lincomb      L(x)    == D(x) + k1 P + k2 P x^s + k3 B + k4 B x^s
"""

from __future__ import annotations

import torch

from .. import _build
from . import field as F
from .field_cuda import mul_mod_plain as _mul

launches = {"spot_checks": 0}


def spot_checks_plain(raw5, tab5, ks4, ic1, ic0, power: int = 3):
    """Plain version of spot_checks: canonicalize the five trace values, then
    each right-hand side as one mul_sum_mod, compared limb for limb.  The
    single products go through the multiply's plain version on either
    device."""
    if power not in (2, 3):
        raise ValueError(f"unsupported transition power {power}")
    p, pg1, d, b, l = (F.canon(raw5[..., i, :]) for i in range(5))
    x, xs, z, z2, k = (tab5[..., i, :] for i in range(5))
    k1, k2, k3, k4 = (ks4[..., i, :] for i in range(4))

    p_pow = [(_mul(p, p), p)] if power == 3 else [(p, p)]
    rhs_t = F.mul_sum_mod(p_pow + [(z, d)], extra=[k])
    ok_t = (pg1 == rhs_t).all(dim=-1)

    rhs_b = F.mul_sum_mod([(b, z2), (ic1, x)],
                          extra=[ic0.expand(x.shape)])
    ok_b = (p == rhs_b).all(dim=-1)

    p_xs = _mul(p, xs)
    b_xs = _mul(b, xs)
    rhs_l = F.mul_sum_mod([(k1, p), (k2, p_xs), (k3, b), (k4, b_xs)],
                          extra=[d])
    ok_l = (l == rhs_l).all(dim=-1)
    return torch.stack([ok_t, ok_b, ok_l], dim=-1)


def spot_checks(raw5, tab5, ks4, ic1, ic0, power: int = 3):
    """Fused transition/boundary/lincomb checks.

    raw5: [..., 5, 16] raw trace limbs (P, Pg1, D, B, L); tab5 [..., 5, 16]
    canonical gathers (x, x^steps, Z, Z2, K); ks4 [..., 4, 16] raw k1..k4
    and ic1/ic0 [..., 16] canonical boundary interpolant coefficients, each
    with 1 in place of the position dim (one row per proof; the plain
    version takes anything that broadcasts); power: transition exponent
    (2 or 3).  Returns ok [..., 3] bool."""
    if raw5.device.type == "cpu":
        return spot_checks_plain(raw5, tab5, ks4, ic1, ic0, power)
    if power not in (2, 3):
        raise ValueError(f"unsupported transition power {power}")
    dev = raw5.device
    lead = raw5.shape[:-2]
    for t, name in ((raw5, "raw5"), (tab5, "tab5"), (ks4, "ks4"),
                    (ic1, "ic1"), (ic0, "ic0")):
        if t.dtype != torch.int32 or t.device != dev:
            raise TypeError(f"{name}: expected int32 on {dev}, got {t.dtype} "
                            f"on {t.device}")
    if raw5.shape != lead + (5, 16) or tab5.shape != lead + (5, 16):
        raise ValueError("spot_checks: raw5 / tab5 shapes disagree")
    # k1..k4 and the interpolant coefficients are per proof: one row for the
    # `group` consecutive positions of the last leading dim
    if not lead:
        raise ValueError("spot_checks: raw5 needs a position dim")
    per_proof = lead[:-1] + (1,)
    if (ks4.shape != per_proof + (4, 16) or ic1.shape != per_proof + (16,)
            or ic0.shape != per_proof + (16,)):
        raise ValueError(
            "spot_checks: on the card ks4 / ic1 / ic0 must hold one row per "
            f"proof, shapes {per_proof + (4, 16)} / {per_proof + (16,)}; got "
            f"{tuple(ks4.shape)} / {tuple(ic1.shape)} / {tuple(ic0.shape)}")
    group = lead[-1]
    raw5, tab5, ks4, ic1, ic0 = (t.contiguous()
                                 for t in (raw5, tab5, ks4, ic1, ic0))
    bits = torch.empty(lead, dtype=torch.int32, device=dev)
    for t in (raw5, tab5, ks4, ic1, ic0):
        if t.data_ptr() % 16:
            raise ValueError("spot_checks: operands must be 16-byte aligned")
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.stark_spot_checks(
            raw5.data_ptr(), tab5.data_ptr(), ks4.data_ptr(), ic1.data_ptr(),
            ic0.data_ptr(), group, power, bits.data_ptr(), bits.numel(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "stark_spot_checks")
    launches["spot_checks"] += 1
    return torch.stack([(bits & 1) != 0, (bits & 2) != 0, (bits & 4) != 0],
                       dim=-1)
