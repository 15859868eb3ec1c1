"""Constraint spot checks on the card: spot_checks (kernel D) with its plain
version.

Counterpart of the JAX package's ops/spot_pallas.py.  One kernel
(csrc/spot_checks.cu) evaluates all three per-position constraint families of
verify_mimc_proof (reference verifier: src/main.rs:163-192):

  transition   P(g1 x) == P(x)^power + K(x) + Z(x) D(x)
  boundary     P(x)    == B(x) Z2(x) + I1 x + I0
  lincomb      L(x)    == D(x) + k1 P + k2 P x^s + k3 B + k4 B x^s

The JAX function takes its operands as 16-bit limbs that the verifier
converts, gathers and stacks first (spot_limbs_plain is its counterpart).
spot_checks takes them where they lie: the proof's main and lincomb value
rows, the spot positions, the raw k-hash words, and the statement tables
packed to 8 little-endian words a row (SpotTables), from which the kernel
gathers x, x^steps, Z, Z2 and K itself.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from . import field as F
from .field_cuda import mul_mod_plain as _mul

launches = {"spot_checks": 0}


class SpotTables(NamedTuple):
    """The statement tables kernel D gathers from, [rows, 8] int32 words of
    little-endian 32-bit limbs, canonical: g2 the powers of G2, z and z2 the
    Z and Z2 tables (all `precision` rows, a power of two), k the K table
    (k_period rows, a power of two: the statement's, or with run-time round
    constants the call's own); log_steps gives x^steps = g2[pos <<
    log_steps]."""
    g2: torch.Tensor
    z: torch.Tensor
    z2: torch.Tensor
    k: torch.Tensor
    log_steps: int


def spot_limbs_plain(raw5, tab5, ks4, ic1, ic0, power: int = 3):
    """The three checks on limb operands, as the JAX function takes them:
    raw5 [..., 5, 16] raw trace limbs (P, Pg1, D, B, L); tab5 [..., 5, 16]
    canonical (x, x^steps, Z, Z2, K); ks4 [..., 4, 16] raw k1..k4; ic1/ic0
    [..., 16] canonical (anything that broadcasts).  Canonicalize the five
    trace values, then each right-hand side as one mul_sum_mod, compared
    limb for limb.  The single products go through the multiply's plain
    version on either device.  Returns ok [..., 3] bool."""
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


def spot_checks_plain(main_value, lincomb_value, positions, kh, ic1, ic0,
                      tables: SpotTables, power: int = 3):
    """Plain version of spot_checks: the limbs and gathers the kernel makes
    in registers, made as tensors, then spot_limbs_plain.  Table indices are
    masked as the kernel masks them (the verifier's positions are in range,
    where masking changes nothing)."""
    n = positions.shape[-1]
    mv = main_value.reshape(*main_value.shape[:-2], n, 2, 3, 8)
    raw5 = torch.stack([F.words_be_to_limbs(w) for w in (
        mv[..., 0, 0, :], mv[..., 1, 0, :], mv[..., 0, 1, :],
        mv[..., 0, 2, :], lincomb_value)], dim=-2)         # [..., n, 5, 16]
    pos = positions.to(torch.int64)
    mask = tables.g2.shape[0] - 1
    tab = [tables.g2[pos & mask], tables.g2[(pos << tables.log_steps) & mask],
           tables.z[pos & mask], tables.z2[pos & mask],
           tables.k[pos & (tables.k.shape[0] - 1)]]
    tab5 = torch.stack([F.words_le_to_limbs(t) for t in tab], dim=-2)
    ks4 = F.words_be_to_limbs(kh)[..., None, :, :]         # [..., 1, 4, 16]
    return spot_limbs_plain(raw5, tab5, ks4, ic1[..., None, :],
                            ic0[..., None, :], power)


def _spot_args(main_value, lincomb_value, positions, kh, ic1, ic0,
               tables: SpotTables, power: int) -> tuple:
    """(the kernel's SpotArgs, the verdicts [..., n, 3] bool it writes, the
    tensors the arguments point into) for spot_checks' operands on their
    device.  The tensors must outlive the launch."""
    dev = positions.device
    lead, n = positions.shape[:-1], positions.shape[-1]
    nlead = len(lead)
    words = {"main_value": main_value, "lincomb_value": lincomb_value,
             "kh": kh, "ic1": ic1, "ic0": ic0, "g2": tables.g2,
             "z": tables.z, "z2": tables.z2, "k": tables.k}
    for name, t in words.items():
        if t.dtype != torch.int32 or t.device != dev:
            raise TypeError(f"spot_checks: {name}: expected int32 on {dev}, "
                            f"got {t.dtype} on {t.device}")
    if positions.dtype != torch.int64:
        raise TypeError("spot_checks: positions must be int64")
    if (main_value.shape != lead + (2 * n, 24)
            or lincomb_value.shape != lead + (n, 8)
            or kh.shape != lead + (4, 8)):
        raise ValueError("spot_checks: operand shapes disagree")
    ic1, ic0 = ic1.expand(lead + (16,)), ic0.expand(lead + (16,))
    for name in ("g2", "z", "z2", "k"):
        t = words[name]
        if t.dim() != 2 or t.shape[1] != 8 or not t.is_contiguous():
            raise ValueError(f"spot_checks: table {name} must be dense "
                             "[rows, 8]")
    rows = tables.g2.shape[0]
    if tables.z.shape[0] != rows or tables.z2.shape[0] != rows:
        raise ValueError("spot_checks: g2 / z / z2 tables differ in rows")
    positions = positions.contiguous()
    ok = torch.empty(lead + (n, 3), dtype=torch.bool, device=dev)
    strides = [_build.proof_stride(t, nlead, f"spot_checks: {name}")
               for name, t in (("main_value", main_value),
                               ("lincomb_value", lincomb_value), ("kh", kh),
                               ("ic1", ic1), ("ic0", ic0))]
    args = _build.SpotArgs(
        main_value.data_ptr(), lincomb_value.data_ptr(), positions.data_ptr(),
        kh.data_ptr(), ic1.data_ptr(), ic0.data_ptr(), tables.g2.data_ptr(),
        tables.z.data_ptr(), tables.z2.data_ptr(), tables.k.data_ptr(),
        ok.data_ptr(),
        *strides, rows, tables.k.shape[0], n, ok.numel() // 3,
        tables.log_steps, power)
    return args, ok, positions


def spot_checks(main_value, lincomb_value, positions, kh, ic1, ic0,
                tables: SpotTables, power: int = 3):
    """Fused transition / boundary / lincomb checks at every spot position.

    main_value [..., 2n, 24] the main trace's value rows (rows 2k, 2k+1 at
    position k and its g1 neighbour) and lincomb_value [..., n, 8], raw
    proof words; positions [..., n] int64; kh [..., 4, 8] the raw k1..k4
    hash words; ic1/ic0 [..., 16] canonical limbs of the boundary
    interpolant; tables the packed statement tables; power: transition
    exponent (2 or 3).  Returns ok [..., n, 3] bool: transition, boundary,
    lincomb."""
    if power not in (2, 3):
        raise ValueError(f"unsupported transition power {power}")
    if positions.device.type == "cpu":
        return spot_checks_plain(main_value, lincomb_value, positions, kh,
                                 ic1, ic0, tables, power)
    dev = positions.device
    args, ok, keep = _spot_args(main_value, lincomb_value, positions, kh,
                                ic1, ic0, tables, power)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.stark_spot_checks(
            args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "stark_spot_checks")
    launches["spot_checks"] += 1
    del keep        # the launch is queued: the copies may go back to the pool
    return ok
