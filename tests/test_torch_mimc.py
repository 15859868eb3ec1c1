"""ops/mimc.mimc (the trace scan; on the CPU its plain version) against the
JAX package's scan and the oracle at 511 rounds, powers 2 and 3, on inputs
that include 0, p - 1, p and 2^256 - 1; the families' compute_output
against JAX's; and the scan kernel's body through its host build against
the plain version.  Tolerance 0."""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from stark_verifier_tpu.config import StarkConfig as JCfg
from stark_verifier_tpu.models.mimc import MimcStatement as JMimc
from stark_verifier_tpu.models.square import SquareStatement as JSquare
from stark_verifier_tpu.ops import mimc as JM
from stark_verifier_tpu_torch import fp
from stark_verifier_tpu_torch.config import StarkConfig
from stark_verifier_tpu_torch.models.mimc import MimcStatement
from stark_verifier_tpu_torch.models.square import SquareStatement
from stark_verifier_tpu_torch.ops import mimc

torch.set_num_threads(1)
P = fp.MODULUS
STEPS = 512                                       # 511 rounds
INPUTS = [0, 1, 3, P - 1, P, 2**256 - 1, 2**255 + 12345, 7 * 2**200]
CONSTS = [(i ** 7) ^ 42 for i in range(64)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def _n(t):
    return np.ascontiguousarray(t.numpy()).view(np.uint32)


@pytest.mark.parametrize("power", [3, 2])
def test_mimc_vs_jax_and_oracle(power):
    """The scan on 8 inputs against JAX's and the oracle's; and the family
    of this power's compute_output at log_steps 9 (512 steps, input 3)
    against the JAX family's, which is the JAX scan of the same input (row
    2 of the JAX result) -- checked once here on the JAX family itself."""
    x = fp.ints_to_limbs(INPUTS)
    c = mimc.round_constants_mimc(64)
    got = _n(mimc.mimc(_t(x), STEPS, _t(c), power))
    want = np.asarray(JM.mimc(jnp.asarray(x), STEPS, jnp.asarray(c), power))
    np.testing.assert_array_equal(got, want)
    assert [fp.limbs_to_int(r) for r in got] == [
        oracle.mimc(v, STEPS, CONSTS, power=power) for v in INPUTS]
    fam, jfam = ((MimcStatement, JMimc) if power == 3
                 else (SquareStatement, JSquare))
    cfg = StarkConfig(log_steps=9, power=power)
    assert cfg.num_steps == STEPS and INPUTS[2] == 3
    jax_out = np.asarray(jfam(JCfg(log_steps=9, power=power))
                         .compute_output(3))
    np.testing.assert_array_equal(jax_out, want[2])
    np.testing.assert_array_equal(
        _n(fam(cfg).compute_output(3, device="cpu")), jax_out)


def test_mimc_edges_of_the_plain_version():
    """steps 1 and 0 run no round (the input comes back raw); a wide limb
    in the input, or in a constant a round reads, gives 0xFFFFFFFF words
    (as kernel E and the scan kernel do); a power other than 2 or 3
    raises."""
    x = _t(fp.ints_to_limbs([P + 5, 9]))
    c = _t(mimc.round_constants_mimc(4))
    for steps in (0, 1):
        assert torch.equal(mimc.mimc(x, steps, c), x)
    wide = x.clone()
    wide[0, 3] = 0x10000
    out = mimc.mimc(wide, 3, c)
    assert (out[0] == -1).all() and fp.limbs_to_int(_n(out[1])) == (
        oracle.mimc(9, 3, [(i ** 7) ^ 42 for i in range(4)]))
    cw = c.clone()
    cw[3, 0] = -1
    assert not (mimc.mimc(x, 4, cw) == -1).all()        # row 3 not read
    assert (mimc.mimc(x, 5, cw) == -1).all()
    with pytest.raises(ValueError, match="power"):
        mimc.mimc(x, 3, c, power=5)
