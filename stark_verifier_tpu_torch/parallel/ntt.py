"""Point-parallel NTT over ranks: butterfly stages across cards.

Counterpart of the JAX package's parallel/ntt.py (make_sharded_ntt over a
device mesh with shard_map and ppermute).  Here a rank is a process with
its card (parallel/mesh.py), and the point axis of the bit-reversed
sequence is cut into contiguous shards of S = n / size points, rank r
holding points [r S, (r + 1) S).  A DIT stage with butterfly distance 2^s
is then

  * LOCAL when 2^(s+1) <= S: the stage of ops/ntt.py on the rank's own
    shard (on the card the passes of the several-stage kernel, one
    launch for up to ten stages);
  * CROSS when 2^s >= S: every point of the shard pairs with the point at
    the same offset on rank r XOR 2^s / S, so the rank swaps its whole shard
    with that one partner (NCCL send and receive on the card; through host
    memory over gloo, which has no send or receive for CUDA tensors) and
    keeps a + w b when it holds the lower points, a - w b when it holds the
    upper ones.  The twiddle depends on the position: T_s[g] =
    w^((n >> (s+1)) (g mod 2^s)), the same for both partners, so no twiddle
    crosses between ranks.

Every rank passes the same global [n, 16] values (as shard_batch takes the
same global batch on every rank) and gets its contiguous [S, 16] slice of
the result; the global bit-reverse gather is then a local index into the
rank's own points of the input, with no collective.  gather_points joins
the slices for a caller that needs the whole result.  Bit-exact with the
one-process ops.ntt.ntt.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from .. import fp
from ..ops import field as F, field_cuda, ntt as ntt_ops
from . import mesh as M


@functools.lru_cache(maxsize=4)
def _cross_tables(root: int, n: int, n_cross: int, modulus: int):
    """Stacked per-position twiddle tables for the last n_cross stages:
    [n_cross, n, 16] uint32 limbs with row s' for stage s = logn - n_cross
    + s', entry g = root^((n >> (s+1)) (g mod 2^s)) (the JAX package's
    _cross_tables; the plain version's operand)."""
    logn = n.bit_length() - 1
    pows = fp.ints_to_limbs_fast(ntt_ops._powers(root, n, modulus))
    out = np.zeros((n_cross, n, fp.NLIMBS), dtype=np.uint32)
    g = np.arange(n)
    for s_i, s in enumerate(range(logn - n_cross, logn)):
        out[s_i] = pows[(g % (1 << s)) * (n >> (s + 1))]
    return out


def _exchange(mesh: M.Mesh, x: torch.Tensor, partner: int) -> torch.Tensor:
    """Send x to `partner` and receive its tensor of the same shape: both
    posted in one batch, so that two partners never wait on each other."""
    where = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    mine = x.to(where).contiguous()
    other = torch.empty_like(mine)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, mine, partner),
                                   dist.P2POp(dist.irecv, other, partner)])
    for r in reqs:
        r.wait()
    return other.to(mesh.device)


def make_sharded_ntt(n: int, root: int, mesh: M.Mesh, inverse: bool = False,
                     modulus: int = fp.MODULUS, lib=None):
    """fn(values) -> this rank's [n / size, 16] slice of ntt(values, root,
    inverse): values [n, 16] limbs, the same on every rank.  The NTT
    kernels on the card, the plain version on the CPU; the cross stages
    exchange with one partner each.  `lib`: the library the launches go
    to (the card's by default); given one, CPU ranks take the kernel
    path too, through the kernel's host build (as the tests drive it)."""
    D = mesh.size
    if n % D:
        raise ValueError(f"n={n} not divisible by the mesh's {D} ranks")
    S = n // D
    logn = n.bit_length() - 1
    logS = S.bit_length() - 1
    if (1 << logn) != n or (1 << logS) != S:
        raise ValueError(f"n={n} and per-shard size {S} must be powers of 2")
    n_cross = logn - logS
    w = ntt_ops._transform_root(root, inverse, modulus)
    lo = mesh.rank * S
    n_inv = pow(n, modulus - 2, modulus)

    def cross_partners(s_i):
        bit = 1 << s_i
        is_hi = bool(mesh.rank & bit)
        # the lower partner's first point, mod 2^s: the twiddle row offset
        off = ((mesh.rank & ~bit) * S) % (1 << (logS + s_i))
        return mesh.rank ^ bit, is_hi, off

    def on_card(values):
        dev = values.device
        perm, tw = ntt_ops._card_tables(w, n, modulus, str(dev))
        scale = (ntt_ops._scale_words(n, modulus, str(dev)) if inverse
                 else None)
        x = ntt_ops.stages(values.reshape(1, n, fp.NLIMBS), perm[lo:lo + S],
                           S, logS, tw, scale if n_cross == 0 else None,
                           lib)[0]
        for s_i in range(n_cross):
            partner, is_hi, off = cross_partners(s_i)
            other = _exchange(mesh, x, partner)
            a, b = (other, x) if is_hi else (x, other)
            last = s_i == n_cross - 1
            x = ntt_ops.cross_stage(a, b, tw, logS + s_i, off,
                                    scale if last else None, lib)[int(is_hi)]
        return x

    def plain(values):
        perm = torch.from_numpy(
            ntt_ops._bitrev_perm(n)[lo:lo + S].astype(np.int64))
        x = values[perm.to(values.device)]
        for tw in ntt_ops._twiddle_stages(w, n, modulus)[:logS]:
            x = ntt_ops.stage_plain(x, torch.from_numpy(tw.astype(np.int32))
                                    .to(values.device))
        crosst = _cross_tables(w, n, n_cross, modulus)
        for s_i in range(n_cross):
            partner, is_hi, _ = cross_partners(s_i)
            other = _exchange(mesh, x, partner)
            a, b = (other, x) if is_hi else (x, other)
            tw = torch.from_numpy(crosst[s_i, lo:lo + S].astype(np.int32))
            wb = field_cuda.mul_mod_plain(tw.to(values.device), b)
            x = F.sub_mod(a, wb) if is_hi else F.add_mod(a, wb)
        if inverse:
            x = field_cuda.mul_mod_plain(x, F.const(n_inv, values.device))
        return x

    def fn(values: torch.Tensor) -> torch.Tensor:
        if tuple(values.shape) != (n, fp.NLIMBS):
            raise ValueError(f"sharded ntt: expected [{n}, 16] limbs, got "
                             f"{tuple(values.shape)}")
        values = values.to(mesh.device)
        kernel = mesh.device.type == "cuda" or lib is not None
        return on_card(values) if kernel else plain(values)

    return fn


def gather_points(mesh: M.Mesh, local: torch.Tensor) -> torch.Tensor:
    """The whole [n, 16] result from every rank's contiguous [n / size, 16]
    slice: each rank writes its slice into a zero buffer and one all_reduce
    sums them (on the card with NCCL, on the host with gloo).  Returns it on
    the rank's device."""
    if mesh.size == 1:
        return local
    S = local.shape[0]
    buf = torch.zeros((S * mesh.size, fp.NLIMBS), dtype=torch.int32,
                      device=mesh.device if mesh.backend == "nccl" else "cpu")
    buf[mesh.rank * S:(mesh.rank + 1) * S] = local.to(buf.device)
    return M._all_reduce(mesh, buf).to(mesh.device)
