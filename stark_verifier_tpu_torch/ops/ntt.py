"""Radix-2 number-theoretic transform over F_p.

Counterpart of the reference's recursive Cooley-Tukey (src/fft.rs:37-86) and
of the JAX package's ops/ntt.py: an iterative decimation-in-time NTT --
bit-reverse permutation, then log2(n) butterfly stages, each stage one
modular multiply, add and subtract over all n/2 pairs.  The recursive
even/odd split of the reference computes exactly this DFT, so outputs are
bit-identical (both are canonical mod p).

The inverse transform follows fft_inv (fft.rs:64-86): same butterflies with
the inverse root, then scale by n^(p-2) mod p.

The butterfly products and the final scaling go through field.mul_mod, so on
the card they are the element-wise multiply kernel (ops/field_cuda.py), with
the stage's twiddle table broadcast over the blocks.  Twiddle factors depend
only on (root, n): host bigints, turned into limb tensors once per device and
cached.  The verifier uses this at the size of the round-constant list (64);
nothing here is tuned for large transforms.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import fp
from . import field as F


@functools.lru_cache(maxsize=32)
def _twiddle_stages(root: int, n: int, modulus: int) -> tuple:
    """Per-stage twiddle tables for an n-point DIT NTT with given root.

    Stage s (s = 0 .. log2(n)-1) has half-block size 2^s and uses twiddles
    w^(n / 2^(s+1) * k) for k < 2^s, where w = root.
    Returns a tuple of [2^s, 16] uint32 numpy arrays.
    """
    logn = n.bit_length() - 1
    if 1 << logn != n:
        raise ValueError(f"n must be a power of two, got {n}")
    m = max(n // 2, 1)
    vals = [1] * m
    cur = 1
    for i in range(1, m):
        cur = cur * root % modulus
        vals[i] = cur
    pows = fp.ints_to_limbs_fast(vals)
    stages = []
    for s in range(logn):
        stride = n >> (s + 1)
        stages.append(np.ascontiguousarray(pows[::stride][: 1 << s]))
    return tuple(stages)


@functools.lru_cache(maxsize=32)
def _bitrev_perm(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


@functools.lru_cache(maxsize=32)
def _device_tables(root: int, n: int, modulus: int, inverse: bool,
                   device: str):
    """(permutation, twiddle stages, n^-1 or None) as tensors on `device`."""
    w = pow(root, modulus - 2, modulus) if inverse else root

    def limbs(a):
        return torch.from_numpy(a.astype(np.int32)).to(device)

    perm = torch.from_numpy(_bitrev_perm(n).astype(np.int64)).to(device)
    stages = tuple(limbs(tw) for tw in _twiddle_stages(w, n, modulus))
    n_inv = (limbs(fp.int_to_limbs(pow(n, modulus - 2, modulus)))
             if inverse else None)
    return perm, stages, n_inv


def ntt(values: torch.Tensor, root: int, inverse: bool = False,
        modulus: int = fp.MODULUS) -> torch.Tensor:
    """n-point NTT/iNTT of [..., n, 16] canonical values; root must have
    multiplicative order exactly n.  The inverse transform uses root^-1 (the
    reference reverses the power list, fft.rs:79-80) and scales by n^-1
    (fft.rs:82-84)."""
    n = values.shape[-2]
    perm, stages, n_inv = _device_tables(root, n, modulus, inverse,
                                         str(values.device))
    x = values[..., perm, :]
    lead = x.shape[:-2]
    for s, tw in enumerate(stages):
        half = 1 << s
        m = half * 2
        xb = x.reshape(lead + (n // m, m, fp.NLIMBS))
        a = xb[..., :half, :]
        t = F.mul_mod(xb[..., half:, :], tw)
        x = torch.cat([F.add_mod(a, t), F.sub_mod(a, t)],
                      dim=-2).reshape(lead + (n, fp.NLIMBS))
    if inverse:
        x = F.mul_mod(x, n_inv)
    return x


def intt(values: torch.Tensor, root: int,
         modulus: int = fp.MODULUS) -> torch.Tensor:
    """Inverse NTT matching the reference's fft_inv (fft.rs:64-86)."""
    return ntt(values, root, inverse=True, modulus=modulus)
