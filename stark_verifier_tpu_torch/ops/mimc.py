"""The MiMC permutation: the trace scan on the device and the host helpers.

Reference: src/utils.rs:8-16 -- note the reference iterates steps-1 times
(utils.rs:11), i.e. the trace has `steps` states and steps-1 transitions.
Counterpart of the JAX package's ops/mimc.py.  mimc runs the scan on the
device: on the card one launch of the scan kernel (csrc/mimc_scan.cu: one
thread an input, the constants staged in shared memory when they fit and
read from their rows when not, one reduction a round), on the CPU its plain
version (a loop of the plain multiply and mul_sum_mod).  The claimed output of a
statement is a statement-level constant, so the verifiers compute it once
on the host (mimc_host), as the JAX package's verifiers do;
models/base.compute_output runs the scan on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build, fp
from . import field as F
from . import field_cuda

launches = {"mimc_scan": 0}


def _rounds(steps: int) -> int:
    return max(steps - 1, 0)


def mimc_plain(inp: torch.Tensor, steps: int, round_constants: torch.Tensor,
               power: int = 3) -> torch.Tensor:
    """The plain version of mimc, on whatever device the tensors lie: the
    JAX package's round (x^(power-1) * x + c through one reduction) as a
    Python loop.  A limb of 2^16 or more in the input, or in any constant,
    that a round reads, gives sixteen 0xFFFFFFFF words, as the kernel
    does."""
    if power not in (2, 3):
        raise ValueError(f"unsupported transition power {power}")
    k = round_constants.shape[0]
    x = inp
    for i in range(_rounds(steps)):
        c = round_constants[i % k].expand(x.shape)
        a = field_cuda.mul_mod_plain(x, x) if power == 3 else x
        x = F.mul_sum_mod([(a, x)], extra=[c])
    used = round_constants[:min(_rounds(steps), k)]     # the rows read
    wide = ((inp >> 16) != 0).any(dim=-1, keepdim=True)
    wide = wide | bool(((used >> 16) != 0).any())
    return torch.where(wide, -1, x)


def mimc(inp: torch.Tensor, steps: int, round_constants: torch.Tensor,
         power: int = 3) -> torch.Tensor:
    """inp: [..., 16] limbs (any values < 2^256); round_constants: [k, 16].
    Returns [..., 16]: steps-1 rounds of x <- x^power + c_(i mod k) (mod p),
    canonical after the first round.  Power 3 is the reference MiMC family
    (utils.rs:8-16), power 2 the square family (models/square.py).  The scan
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if power not in (2, 3):
        raise ValueError(f"unsupported transition power {power}")
    if inp.device.type == "cpu":
        return mimc_plain(inp, steps, round_constants, power)
    dev = inp.device
    for t, name in ((inp, "inp"), (round_constants, "round_constants")):
        if t.dtype != torch.int32 or t.device != dev or t.shape[-1] != 16:
            raise TypeError(f"mimc: {name}: expected [.., 16] int32 limbs on "
                            f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                            f"{t.device}")
    if round_constants.dim() != 2 or round_constants.shape[0] < 1:
        raise ValueError("mimc: round_constants must be [k, 16], k >= 1")
    x, consts = (t.contiguous() for t in (inp.reshape(-1, 16),
                                          round_constants))
    x, consts = (t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (x, consts))
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out.reshape(inp.shape)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.stark_mimc_scan(
            x.data_ptr(), consts.data_ptr(), consts.shape[0], _rounds(steps),
            power, out.data_ptr(), x.shape[0],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "stark_mimc_scan")
    launches["mimc_scan"] += 1
    return out.reshape(inp.shape)


def round_constants_mimc(n: int = 64) -> np.ndarray:
    """(i^7) XOR 42 for i < n (reference: src/main.rs:209-212).  Host-side;
    returns [n, 16] uint32 limbs."""
    return fp.ints_to_limbs([(i ** 7) ^ 42 for i in range(n)])


def mimc_host(inp: int, steps: int, constants: list[int] | None = None,
              modulus: int = fp.MODULUS, power: int = 3) -> int:
    """Host (exact-int) MiMC output: steps-1 rounds of
    x <- x^power + c_{i mod k} (mod p)."""
    if constants is None:
        constants = [(i ** 7) ^ 42 for i in range(64)]
    out = inp
    n = len(constants)
    for i in range(steps - 1):
        out = (out ** power + constants[i % n]) % modulus
    return out
