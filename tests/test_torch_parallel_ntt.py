"""parallel/ntt.make_sharded_ntt on four gloo ranks on the CPU (one
parallel.mesh.launch for the file): at n = 64 and 4,096 (two cross stages
each), forward and inverse, every rank's slice and the gathered result equal
the one-process ntt and the oracle; at n = 256 the gathered result equals
the JAX package's make_sharded_ntt on a 4-device mesh; and the ranks' kernel
path (the stage launches, the cross stage, the exchanges) through the host
build of csrc/ntt_stage.cu and csrc/ntt_block.cu equals it too.  Tolerance 0."""

import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from stark_verifier_tpu.parallel import mesh as JMesh
from stark_verifier_tpu.parallel.ntt import make_sharded_ntt as jax_sharded
from stark_verifier_tpu_torch import _build, fp
from stark_verifier_tpu_torch.ops import ntt
from stark_verifier_tpu_torch.parallel import mesh as M
from stark_verifier_tpu_torch.parallel import ntt as PN
from stark_verifier_tpu_torch.parallel import rank_checks as R

torch.set_num_threads(1)
P = fp.MODULUS
PLAIN = [(64, False), (64, True), (4096, False), (4096, True), (256, False)]
KERNEL = [(64, False), (64, True), (4096, True)]


def _root(n):
    return pow(7, (P - 1) // n, P)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's records of the plain and the kernel path (the latter
    None where there is no host compiler).  The build and the world took
    6.7 s together in a whole suite's run on six workers; each has 60 s."""
    cxx = shutil.which("g++") or shutil.which("c++")
    steps = [(R.sharded_ntt, dict(cases=PLAIN, values=True))]
    if cxx is not None:
        lib = tmp_path_factory.mktemp("pntt") / "libntt_host.so"
        subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                        "-fPIC", "-o", str(lib),
                        str(_build.CSRC / "ntt_stage.cu"),
                        str(_build.CSRC / "ntt_block.cu")], check=True,
                       timeout=60)
        steps.append((R.sharded_ntt, dict(cases=KERNEL, host_lib=str(lib))))
    ranks = M.launch(4, R.run_steps, steps, devices="cpu", timeout_s=60)
    return [r["steps"] for r in ranks]


@pytest.mark.parametrize("case", range(len(PLAIN)))
def test_every_rank_equals_the_one_process_ntt(world, case):
    for steps in world:
        rec = steps[0]["result"][case]
        assert (rec["n"], rec["inverse"]) == PLAIN[case]
        assert rec["slice_equal"] and rec["gathered_equal"]
    first = world[0][0]["result"][case]["values"]
    for steps in world[1:]:
        np.testing.assert_array_equal(steps[0]["result"][case]["values"],
                                      first)


@pytest.mark.parametrize("case", [2, 3])
def test_gathered_equals_the_oracle(world, case):
    """n = 4,096 on raw values (the edge values first): congruent to the
    oracle's FFT point for point."""
    n, inverse = PLAIN[case]
    vals = [fp.limbs_to_int(r) for r in R.ntt_values(n, n)]
    want = (oracle.fft_inv if inverse else oracle.fft_fwd)(vals, _root(n))
    got = world[0][0]["result"][case]["values"]
    assert [fp.limbs_to_int(r) % P for r in got] == want


def test_gathered_equals_jax_sharded_ntt_on_4_devices(world):
    n = 256
    fn = jax_sharded(n, _root(n), JMesh.make_mesh(4))
    want = np.asarray(fn(jnp.asarray(R.ntt_values(n, n))))
    np.testing.assert_array_equal(world[0][0]["result"][4]["values"], want)


def test_kernel_path_on_the_ranks(world):
    if len(world[0]) < 2:
        pytest.skip("no host C++ compiler for the stage kernel's host build")
    for steps in world:
        assert all(r["slice_equal"] and r["gathered_equal"]
                   for r in steps[1]["result"])
        # (64: 4 local stages in one pass + 2 cross; 4,096: 10 in one pass
        # + 2 cross), twice a case
        assert steps[1]["launches"]["ntt_block"] == 2 * 3
        assert steps[1]["launches"]["ntt_stage"] == 2 * (2 + 2 + 2)
        assert steps[0]["launches"]["ntt_stage"] == 0


def test_one_rank_mesh_and_refusals():
    mesh = M.Mesh(1, 0, torch.device("cpu"))
    x = torch.from_numpy(R.ntt_values(32, 1).view(np.int32))
    for inverse in (False, True):
        assert torch.equal(PN.make_sharded_ntt(32, _root(32), mesh,
                                               inverse=inverse)(x),
                           ntt.ntt(x, _root(32), inverse=inverse))
    assert PN.gather_points(mesh, x) is x
    with pytest.raises(ValueError, match="not divisible"):
        PN.make_sharded_ntt(32, _root(32), M.Mesh(3, 0, torch.device("cpu")))
    with pytest.raises(ValueError, match="expected"):
        PN.make_sharded_ntt(32, _root(32), mesh)(x[:16])
