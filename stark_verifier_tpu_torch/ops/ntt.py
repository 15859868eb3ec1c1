"""Radix-2 number-theoretic transform over F_p.

Counterpart of the reference's recursive Cooley-Tukey (src/fft.rs:37-86) and
of the JAX package's ops/ntt.py: an iterative decimation-in-time NTT --
bit-reverse permutation, then log2(n) butterfly stages, each stage one
modular multiply, add and subtract over all n/2 pairs.  The recursive
even/odd split of the reference computes exactly this DFT, so outputs are
bit-identical (both are canonical mod p).

The inverse transform follows fft_inv (fft.rs:64-86): same butterflies with
the inverse root, then scale by n^(p-2) mod p.

On the card a transform runs in passes of up to ten stages, one launch
each (csrc/ntt_block.cu: a block holds sub-transforms of 2^k points in
shared memory and runs the pass's k stages there): the first pass gathers
the bit-reversed input from the caller's [.., n, 16] limbs (which it never
writes), passes between work in place on a buffer of 8 words a value, and
the last writes the [.., n, 16] result, multiplied by n^-1 for the inverse.
2^20 points take two launches, 64 points one.  The one-stage kernel
(csrc/ntt_stage.cu) carries the sharded NTT's cross stages (cross_stage).
On the CPU the same transform runs as its plain version (ntt_plain: the
stage as the JAX package writes it, with the plain multiply).  Twiddle
factors depend only on (root, n): host bigints, cached (see _card_tables
and _twiddle_stages for what each cache holds).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from .. import _build, debug, fp
from . import field as F
from . import field_cuda

launches = {"ntt_block": 0, "ntt_stage": 0}

_PASS_STAGES = 10  # stages a pass at most (sub-transforms of 1,024 points)
_PASS_SUBS = 2     # sub-transforms a block in later passes (runs of 2 points)
_PASS_TILE = 1024  # points a block's tile at most (csrc/ntt_block.cu's limit)


def _log2(n: int) -> int:
    logn = n.bit_length() - 1
    if n < 1 or 1 << logn != n:
        raise ValueError(f"n must be a power of two, got {n}")
    return logn


def _powers(w: int, n: int, modulus: int) -> list:
    """w^0 .. w^(n/2 - 1) (one entry for n = 1) as host ints."""
    m = max(n // 2, 1)
    vals = [1] * m
    cur = 1
    for i in range(1, m):
        cur = cur * w % modulus
        vals[i] = cur
    return vals


@functools.lru_cache(maxsize=32)
def _twiddle_stages(root: int, n: int, modulus: int) -> tuple:
    """Per-stage twiddle tables for an n-point DIT NTT with given root.

    Stage s (s = 0 .. log2(n)-1) has half-block size 2^s and uses twiddles
    w^(n / 2^(s+1) * k) for k < 2^s, where w = root.
    Returns a tuple of [2^s, 16] uint32 numpy arrays (n - 1 rows in all).
    """
    logn = _log2(n)
    pows = fp.ints_to_limbs_fast(_powers(root, n, modulus))
    stages = []
    for s in range(logn):
        stride = n >> (s + 1)
        stages.append(np.ascontiguousarray(pows[::stride][: 1 << s]))
    return tuple(stages)


@functools.lru_cache(maxsize=32)
def _bitrev_perm(n: int) -> np.ndarray:
    logn = _log2(n)
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


def _words(vals) -> np.ndarray:
    """Host ints < 2^256 -> [len, 8] little-endian 32-bit words (int32 bit
    patterns), the kernel's working layout."""
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").view(np.int32).reshape(-1, 8)


@functools.lru_cache(maxsize=64)
def _transform_root(root: int, inverse: bool, modulus: int) -> int:
    """root, or root^-1 for the inverse (cached: a 256-bit power on the host
    costs more than a small transform on the card)."""
    return pow(root, modulus - 2, modulus) if inverse else root


@functools.cache
def _card_tables(w: int, n: int, modulus: int, device: str):
    """(bit-reverse permutation [n] int32, the powers w^0 .. w^(n/2 - 1)
    packed [n/2, 8] int32) on `device`: what the kernels read.  At
    n = 2^20 that is 4 MB and 16 MB a (root, direction, device); every stage
    reads its twiddles from the one power table at a stride.  Kept for the
    process's life (a handful of transforms a process): a CUDA graph that
    captured a transform replays from these tables."""
    perm = torch.from_numpy(_bitrev_perm(n).astype(np.int32)).to(device)
    tw = torch.from_numpy(_words(_powers(w, n, modulus)).copy()).to(device)
    return perm, tw


@functools.cache
def _scale_words(n: int, modulus: int, device: str) -> torch.Tensor:
    """n^-1 packed [8] on `device` (cached for the process's life, as
    _card_tables: a transform copies nothing to the card, so that its
    launches can be captured in a CUDA graph, which then replays from
    it)."""
    return torch.from_numpy(
        _words([pow(n, modulus - 2, modulus)]).copy()).reshape(8).to(device)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def stage_plain(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """One DIT stage of [..., n, 16] values with the stage's [half, 16]
    twiddle table: the upper half b of every block of 2 half points becomes
    t = b * w, the block (a + t, a - t).  The JAX package's stage, with the
    plain multiply (so that it is built on no kernel)."""
    n, half = x.shape[-2], tw.shape[-2]
    lead = x.shape[:-2]
    xb = x.reshape(lead + (n // (2 * half), 2 * half, fp.NLIMBS))
    a = xb[..., :half, :]
    t = field_cuda.mul_mod_plain(xb[..., half:, :], tw)
    return torch.cat([F.add_mod(a, t), F.sub_mod(a, t)],
                     dim=-2).reshape(lead + (n, fp.NLIMBS))


def ntt_plain(values: torch.Tensor, root: int, inverse: bool = False,
              modulus: int = fp.MODULUS) -> torch.Tensor:
    """The plain version of ntt, on whatever device the values lie."""
    n = values.shape[-2]
    w = _transform_root(root, inverse, modulus)
    perm = torch.from_numpy(_bitrev_perm(n).astype(np.int64)).to(
        values.device)
    x = values[..., perm, :]
    for tw in _twiddle_stages(w, n, modulus):
        x = stage_plain(x, torch.from_numpy(tw.astype(np.int32)).to(
            values.device))
    if inverse:
        x = field_cuda.mul_mod_plain(
            x, F.const(pow(n, modulus - 2, modulus), values.device))
    return x


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(dev: torch.device):
    """The current stream of `dev` for a launch (None on the CPU, where the
    host build of the kernel runs CPU tensors, as the tests do)."""
    return (torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda"
            else None)


def _on(dev: torch.device):
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _launch(lib, stream, args: _build.NttStageArgs) -> None:
    """One stage launch."""
    _build.check(lib.stark_ntt_stage(ctypes.byref(args), stream),
                 "stark_ntt_stage")
    launches["ntt_stage"] += 1


def _launch_pass(lib, stream, args: _build.NttBlockArgs) -> None:
    """One launch of several stages."""
    _build.check(lib.stark_ntt_block(ctypes.byref(args), stream),
                 "stark_ntt_block")
    launches["ntt_block"] += 1


def passes(count: int, n: int) -> list:
    """[(s0, k, log2 C), ...]: the passes of the first `count` stages of an
    n-point transform, as few as _PASS_STAGES allows and balanced (2^20
    points: 10 + 10, 2^13: 7 + 6), each with the log2 of its sub-transforms
    a block (0 in the first pass, whose points are contiguous; 1 after it
    while the tile stays within _PASS_TILE).  A transform of up to 2^20
    points is held to two launches, although three passes of 7 stages were
    faster at 2^20 on the card (PERF.md section 6)."""
    m = -(-count // _PASS_STAGES)
    out, s0 = [], 0
    for i in range(m):
        k = count // m + (i < count % m)
        subs = 1 if s0 == 0 else max(1, min(1 << s0, _PASS_SUBS,
                                            _PASS_TILE >> k, n >> k))
        out.append((s0, k, subs.bit_length() - 1))
        s0 += k
    return out


def stages(src: torch.Tensor, perm: torch.Tensor, n: int, count: int,
           tw: torch.Tensor, scale: torch.Tensor | None = None,
           lib=None) -> torch.Tensor:
    """The first `count` DIT stages of a transform, in passes of up to
    _PASS_STAGES stages, one kernel launch each: src [lead, src_n, 16] limbs,
    point i of transform t read from src[t, perm[i]] (perm [n] int32); tw
    the packed power table of the transform's root (stage s reads it at
    stride rows / 2^s); scale, packed [8] or None, multiplies the last
    stage's results.  Returns [lead, n, 16] limbs; src is only read.  count
    = 0 is the gather alone (and the scale through the multiply kernel)."""
    lib = lib or _build.load()
    lead, src_n = src.shape[0], src.shape[1]
    dev = src.device
    if count == 0:
        out = src[:, perm.long(), :]
        if scale is not None:
            out = F.mul_mod(out, F.words_le_to_limbs(scale))
        return out
    plan = passes(count, n)
    src = _aligned(src)
    out = torch.empty((lead, n, fp.NLIMBS), dtype=torch.int32, device=dev)
    work = (torch.empty((lead, n, 8), dtype=torch.int32, device=dev)
            if len(plan) > 1 else None)
    args = _build.NttBlockArgs(tw=tw.data_ptr(), lead=lead, n=n,
                               tw_rows=tw.shape[0])
    with _on(dev):
        stream = _stream(dev)
        for i, (s0, k, lc) in enumerate(plan):
            first, last = i == 0, i == len(plan) - 1
            args.src = (src if first else work).data_ptr()
            args.dst = (out if last else work).data_ptr()
            args.perm = perm.data_ptr() if first else None
            args.scale = (scale.data_ptr() if last and scale is not None
                          else None)
            args.src_n = src_n if first else n
            args.s0, args.k, args.lc = s0, k, lc
            args.src_limbs, args.dst_limbs = int(first), int(last)
            _launch_pass(lib, stream, args)
    return out


def cross_stage(a: torch.Tensor, b: torch.Tensor, tw: torch.Tensor, s: int,
                tw_off: int, scale: torch.Tensor | None = None,
                lib=None) -> torch.Tensor:
    """One stage whose pairs are (a[j], b[j]), j < len(a), with the twiddle
    of row (tw_off + j) * (rows >> s) of the power table: [2, len, 16], the
    lo sides then the hi sides.  One kernel launch (a stage of the sharded
    NTT whose partner points lie on another rank)."""
    lib = lib or _build.load()
    half = a.shape[0]
    buf = torch.cat([a, b]).contiguous()
    out = torch.empty_like(buf)
    rows = tw.shape[0]
    args = _build.NttStageArgs(
        src=buf.data_ptr(), perm=None, tw=tw.data_ptr(),
        scale=None if scale is None else scale.data_ptr(),
        dst=out.data_ptr(), lead=1, n=2 * half, src_n=2 * half, half=half,
        tw_rows=rows, tw_stride=rows >> s, tw_off=tw_off, src_limbs=1,
        dst_limbs=1)
    with _on(buf.device):
        _launch(lib, _stream(buf.device), args)
    return out.reshape(2, half, fp.NLIMBS)


def ntt_kernel(values: torch.Tensor, root: int, inverse: bool = False,
               modulus: int = fp.MODULUS, lib=None) -> torch.Tensor:
    """ntt through the several-stage kernel, one launch a pass (`lib`: the
    kernels' library, by default the card's)."""
    n = values.shape[-2]
    logn = _log2(n)
    dev = values.device
    perm, tw = _card_tables(_transform_root(root, inverse, modulus), n,
                            modulus, str(dev))
    scale = _scale_words(n, modulus, str(dev)) if inverse else None
    lead = values.shape[:-2]
    src = values.reshape((-1, n, fp.NLIMBS))
    return stages(src, perm, n, logn, tw, scale, lib).reshape(
        lead + (n, fp.NLIMBS))


def ntt(values: torch.Tensor, root: int, inverse: bool = False,
        modulus: int = fp.MODULUS) -> torch.Tensor:
    """n-point NTT/iNTT of [..., n, 16] values; root must have
    multiplicative order exactly n.  The inverse transform uses root^-1 (the
    reference reverses the power list, fft.rs:79-80) and scales by n^-1
    (fft.rs:82-84).  Inputs may be any values < 2^256 (stage 0 adds and
    subtracts them raw, as the JAX package does); limbs < 2^16.  The
    several-stage kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    _log2(values.shape[-2])
    debug.check_limbs(values, "ntt input")
    if values.device.type == "cpu":
        return ntt_plain(values, root, inverse, modulus)
    if values.dtype != torch.int32 or values.shape[-1] != fp.NLIMBS:
        raise TypeError(f"ntt: expected [.., n, 16] int32 limbs, got "
                        f"{values.dtype} {tuple(values.shape)}")
    return ntt_kernel(values, root, inverse, modulus)


def intt(values: torch.Tensor, root: int,
         modulus: int = fp.MODULUS) -> torch.Tensor:
    """Inverse NTT matching the reference's fft_inv (fft.rs:64-86)."""
    return ntt(values, root, inverse=True, modulus=modulus)
