"""Element-wise modular multiply on the card: mul_mod (kernel E) with its
plain version.

Counterpart of the JAX package's ops/field_pallas.py.  The kernel
(csrc/field_mul.cu) takes the public layout as it lies -- [.., 16] int32
tensors of 16-bit limbs -- and broadcasts a smaller operand that is a
trailing block of the larger one (a [16] constant, a twiddle table) by a
period, without a copy.  ops/field.mul_mod dispatches here: the kernel for a
CUDA tensor (or an exception), the plain version for a CPU tensor, and no
switch in between.

Limbs must lie in [0, 2^16).  An element with a limb outside that range on
either side is rejected, not wrapped: its result is sixteen limbs of -1 (the
word 0xFFFFFFFF), which is no valid element, compares equal to none, and
stays so through every later product.  Kernel and plain version agree on
that word for word.
"""

from __future__ import annotations

import torch

from .. import _build
from . import field as F

launches = {"mul_mod": 0}


def mul_mod_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of mul_mod: schoolbook limb columns in int64, folded
    mod p (ops/field.py), on whatever device the tensors lie."""
    out = F._reduce_cols(list(F._mul_acc(a, b).unbind(-1)))
    bad = (((a | b) >> 16) != 0).any(dim=-1, keepdim=True)
    return torch.where(bad, -1, out)


def _period(t: torch.Tensor, lead: tuple) -> tuple:
    """(tensor, period in elements) for one operand against the broadcast
    leading shape `lead`: an operand whose own leading shape is a trailing
    block of `lead` repeats with its element count as the period; any other
    broadcast is materialized."""
    own = tuple(t.shape[:-1])
    while own and own[0] == 1:
        own = own[1:]
    if own != lead[len(lead) - len(own):]:
        t, own = t.expand(lead + (16,)), lead
    n = 1
    for s in own:
        n *= s
    return t.contiguous(), n


def mul_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p, canonical, element-wise over broadcast [.., 16] limb
    tensors; inputs may be any values < 2^256 (not only canonical ones)."""
    if a.device.type == "cpu":
        return mul_mod_plain(a, b)
    dev = a.device
    for t, name in ((a, "a"), (b, "b")):
        if t.dtype != torch.int32 or t.device != dev:
            raise TypeError(f"mul_mod: {name}: expected int32 limbs on {dev}, "
                            f"got {t.dtype} on {t.device}")
        if t.dim() < 1 or t.shape[-1] != 16:
            raise ValueError(f"mul_mod: {name}: expected [.., 16] limbs, got "
                             f"{tuple(t.shape)}")
    lead = tuple(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
    a, a_period = _period(a, lead)
    b, b_period = _period(b, lead)
    out = torch.empty(lead + (16,), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    for t in (a, b, out):
        if t.data_ptr() % 16:
            raise ValueError("mul_mod: operands must be 16-byte aligned")
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.stark_mul_mod(
            a.data_ptr(), a_period, b.data_ptr(), b_period, out.data_ptr(),
            out.numel() // 16, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "stark_mul_mod")
    launches["mul_mod"] += 1
    return out
