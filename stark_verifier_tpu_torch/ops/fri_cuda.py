"""FRI row check on the card: eval4_rows (kernel C) with its plain version.

Counterpart of the JAX package's ops/fri_pallas.py.  The kernel
(csrc/fri_rows.cu) speaks the WIRE encoding on both ends: row values enter as
the proof's 8-word big-endian rows and the result leaves as 8 BE words, so the
comparison with the committed column value runs on the proof's word arrays
(the encoding is bijective).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from . import field as F, quartic

launches = {"eval4_rows": 0}


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


def eval4_rows_plain(x1_inv, x1sq_inv, ys_words, sx, ginv, inv4):
    """Plain version of eval4_rows: words -> limbs, the even/odd-split
    evaluation in ops/quartic.py (which canonicalizes sx and squares it
    first), limbs -> words."""
    dev = ys_words.device
    lhs = quartic.eval4_even_odd(
        x1_inv, x1sq_inv, F.words_be_to_limbs(ys_words), sx,
        _as_tensor(ginv, dev), _as_tensor(inv4, dev))
    return F.limbs_to_words_be(lhs)


def eval4_rows(x1_inv, x1sq_inv, ys_words, sx, ginv, inv4):
    """Fused words_be_to_limbs + quartic.eval4_even_odd + limbs_to_words_be.

    x1_inv/x1sq_inv [..., G, 16] canonical power-table gathers; ys_words
    [..., G, 4, 8] raw proof word rows (fri["poly_value"] regrouped by
    query); sx [..., 16] raw, broadcast over G; ginv/inv4 [16] HOST constants
    g^{-1}, 4^{-1} (numpy limbs).  Returns [..., G, 8] BE words of the
    canonical evaluation -- compare directly against the committed column
    value words."""
    if ys_words.device.type == "cpu":
        return eval4_rows_plain(x1_inv, x1sq_inv, ys_words, sx, ginv, inv4)
    dev = ys_words.device
    lead = x1_inv.shape[:-1]                              # [..., G]
    for t, name in ((x1_inv, "x1_inv"), (x1sq_inv, "x1sq_inv"),
                    (ys_words, "ys_words"), (sx, "sx")):
        if t.dtype != torch.int32 or t.device != dev:
            raise TypeError(f"{name}: expected int32 on {dev}, got {t.dtype} "
                            f"on {t.device}")
    if (not lead or x1_inv.shape != lead + (16,)
            or x1sq_inv.shape != lead + (16,)
            or ys_words.shape != lead + (4, 8)
            or sx.shape != lead[:-1] + (16,)):
        raise ValueError("eval4_rows: operand shapes disagree")
    # sx goes in raw: the kernel canonicalizes and squares it per thread
    sx, x1_inv, x1sq_inv, ys_words = (
        sx.contiguous(), x1_inv.contiguous(), x1sq_inv.contiguous(),
        ys_words.contiguous())
    out = torch.empty(lead + (8,), dtype=torch.int32, device=dev)
    for t in (sx, x1_inv, x1sq_inv, ys_words, out):
        if t.data_ptr() % 16:
            raise ValueError("eval4_rows: operands must be 16-byte aligned")
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.stark_eval4_rows(
            ys_words.data_ptr(), sx.data_ptr(),
            x1_inv.data_ptr(), x1sq_inv.data_ptr(),
            _limbs_to_u32x8(ginv), _limbs_to_u32x8(inv4), lead[-1],
            out.data_ptr(), out.numel() // 8,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "stark_eval4_rows")
    launches["eval4_rows"] += 1
    return out
