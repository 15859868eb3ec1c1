"""FRI row check on the card: fri_rows (kernel C) with its plain version.

Counterpart of the JAX package's ops/fri_pallas.py together with the glue
of its protocol/verify.py around it.  The JAX function, eval4_rows here too,
takes x1^-1 and x1^-2 gathered from the 16-bit-limb power table, special_x
as limbs and the poly rows regrouped by query, and returns the big-endian
words of the evaluations for the verifier to compare with the committed
column values.  fri_rows takes the operands where they lie: the proof's poly
value rows and column values, the column indices, the roots, and the power
table packed to 8 little-endian words a row (the verifier's g2_words, which
kernel D reads too).  The kernel (csrc/fri_rows.cu) gathers, evaluates and
compares, and writes one ok byte a row group.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from . import field as F, quartic

launches = {"fri_rows": 0}


def _limbs_to_u32x8(limbs16) -> ctypes.Array:
    """[16] 16-bit limbs (numpy or tensor) -> ctypes array of 8 LE 32-bit limbs."""
    l = np.asarray(limbs16.cpu() if isinstance(limbs16, torch.Tensor)
                   else limbs16).astype(np.uint32)
    return (ctypes.c_uint32 * 8)(
        *[int(l[2 * k]) | (int(l[2 * k + 1]) << 16) for k in range(8)])


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.asarray(x).astype(np.int32)).to(device)


def eval4_rows(x1_inv, x1sq_inv, ys_words, sx, ginv, inv4):
    """The JAX function's signature, plain: words -> limbs, the even/odd-split
    evaluation of ops/quartic.py (which canonicalizes sx and squares it
    first), limbs -> words.

    x1_inv/x1sq_inv [..., G, 16] canonical power-table gathers; ys_words
    [..., G, 4, 8] raw proof word rows (fri["poly_value"] regrouped by
    query); sx [..., 16] raw, broadcast over G; ginv/inv4 [16] constants
    g^{-1}, 4^{-1} (numpy limbs).  Returns [..., G, 8] BE words of the
    canonical evaluation."""
    dev = ys_words.device
    lhs = quartic.eval4_even_odd(
        x1_inv, x1sq_inv, F.words_be_to_limbs(ys_words), sx,
        _as_tensor(ginv, dev), _as_tensor(inv4, dev))
    return F.limbs_to_words_be(lhs)


def fri_rows_plain(poly_value, col_value, ys, l_root, root2, g2_words, ginv,
                   inv4):
    """Plain version of fri_rows: the index arithmetic and the gathers the
    kernel makes in registers, made as tensors, then eval4_rows and the
    compare.  Returns (ok [..., L, q] bool, lhs [..., L, q, 8] words)."""
    nl, q = ys.shape[-2:]
    mask = g2_words.shape[0] - 1
    # y * 4^l: the masks keep the reference's uint32 wrap-around (rows
    # divides 2^32)
    shift = 2 * torch.arange(nl, dtype=torch.int64, device=ys.device)
    e1 = (ys & 0xFFFFFFFF) << shift[:, None]
    x1_inv = F.words_le_to_limbs(g2_words[(-e1) & mask])
    x1sq_inv = F.words_le_to_limbs(g2_words[(-2 * e1) & mask])
    prev = torch.cat([l_root[..., None, :], root2[..., :-1, :]], dim=-2)
    rows = poly_value.reshape(*poly_value.shape[:-2], q, 4, 8)
    lhs = eval4_rows(x1_inv, x1sq_inv, rows, F.words_be_to_limbs(prev),
                     ginv, inv4)
    return (lhs == col_value).all(dim=-1), lhs


def _fri_args(poly_value, col_value, ys, l_root, root2, g2_words, ginv,
              inv4, want_lhs: bool) -> tuple:
    """(the kernel's FriRowsArgs, ok [..., L, q] bool, lhs words or None,
    the copies the arguments point into) for fri_rows' operands on their
    device.  The tensors must outlive the launch."""
    dev = ys.device
    lead, (nl, q) = ys.shape[:-2], ys.shape[-2:]
    nlead = len(lead)
    words = {"poly_value": poly_value, "col_value": col_value,
             "l_root": l_root, "root2": root2, "g2_words": g2_words}
    for name, t in words.items():
        if t.dtype != torch.int32 or t.device != dev:
            raise TypeError(f"fri_rows: {name}: expected int32 on {dev}, got "
                            f"{t.dtype} on {t.device}")
    if ys.dtype != torch.int64:
        raise TypeError("fri_rows: ys must be int64")
    if (poly_value.shape != lead + (nl, 4 * q, 8)
            or col_value.shape != lead + (nl, q, 8)
            or l_root.shape != lead + (8,) or root2.shape != lead + (nl, 8)):
        raise ValueError("fri_rows: operand shapes disagree")
    if (g2_words.dim() != 2 or g2_words.shape[1] != 8
            or not g2_words.is_contiguous()):
        raise ValueError("fri_rows: the power table must be dense [rows, 8]")
    ys = ys.contiguous()
    ok = torch.empty(lead + (nl, q), dtype=torch.bool, device=dev)
    lhs = (torch.empty(lead + (nl, q, 8), dtype=torch.int32, device=dev)
           if want_lhs else None)
    strides = [_build.proof_stride(t, nlead, f"fri_rows: {name}")
               for name, t in words.items() if name != "g2_words"]
    args = _build.FriRowsArgs(
        poly_value.data_ptr(), col_value.data_ptr(), ys.data_ptr(),
        l_root.data_ptr(), root2.data_ptr(), g2_words.data_ptr(),
        ok.data_ptr(), None if lhs is None else lhs.data_ptr(), *strides,
        g2_words.shape[0], nl, q, ok.numel(), _limbs_to_u32x8(ginv),
        _limbs_to_u32x8(inv4))
    return args, ok, lhs, ys


def fri_rows(poly_value, col_value, ys, l_root, root2, g2_words, ginv, inv4,
             lhs: bool = False):
    """The FRI row check of every level and query.

    poly_value [..., L, 4q, 8] and col_value [..., L, q, 8] raw proof words
    (fri["poly_value"], fri["col_value"]); ys [..., L, q] int64 column
    indices; l_root [..., 8] and root2 [..., L, 8] the roots' words
    (special_x of level l is the previous level's root, raw); g2_words
    [rows, 8] the powers of G2 packed to little-endian words (rows a power
    of two, G2 of order rows); ginv/inv4 [16] host limbs of g^{-1}, 4^{-1}.
    Returns ok [..., L, q] bool: the canonical evaluation of the cubic
    through a query's four rows at special_x equals the committed value,
    word for word.  With lhs=True, returns (ok, the evaluations' big-endian
    words [..., L, q, 8])."""
    if ys.device.type == "cpu":
        ok, words = fri_rows_plain(poly_value, col_value, ys, l_root, root2,
                                   g2_words, ginv, inv4)
        return (ok, words) if lhs else ok
    dev = ys.device
    args, ok, words, keep = _fri_args(poly_value, col_value, ys, l_root,
                                      root2, g2_words, ginv, inv4, lhs)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.stark_fri_rows(args,
                                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "stark_fri_rows")
    launches["fri_rows"] += 1
    del keep        # the launch is queued: the copy may go back to the pool
    return (ok, words) if lhs else ok
