"""The slices as a whole: the port's verifier against the JAX package's on one
batch of a fresh proof, its 12 single-site tamperings and a few more good
copies; the unshared walk on the same batch and on a padded one with a
short-depth proof, group by group against the JAX package's verify_branches;
the runtime-statement verifier; plus the chunked form, the bytes facade and a
second statement family against the oracle.

The JAX verifier costs minutes to compile for each batch shape, so this file
calls it with exactly one shape and is the only port test that does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
import prover
from stark_verifier_tpu.config import StarkConfig as JCfg
from stark_verifier_tpu.ops import merkle as JM
from stark_verifier_tpu.proofio import device as jdevice, wire as jwire
from stark_verifier_tpu.protocol import verify as JV
import stark_verifier_tpu_torch as svt
from stark_verifier_tpu_torch import fp
from stark_verifier_tpu_torch.config import StarkConfig
from stark_verifier_tpu_torch.ops import merkle as M
from stark_verifier_tpu_torch.proofio import device, wire
from stark_verifier_tpu_torch.protocol import verify as V

torch.set_num_threads(1)
CONSTS = [(i ** 7) ^ 42 for i in range(64)]
CFG = StarkConfig(log_steps=9)
SITES = [
    ("merkle_root",), ("l_merkle_root",),
    ("fri", "root2"), ("fri", "col_value"), ("fri", "col_sibling"),
    ("fri", "poly_value"), ("fri", "col_witness", 0),
    ("fri", "poly_witness", 2),
    ("main", "value"), ("main", "witness"),
    ("lincomb", "value"), ("lincomb", "sibling"),
]
N_GOOD_TAIL = 3
EXPECT = [True] + [False] * len(SITES) + [True] * N_GOOD_TAIL


@pytest.fixture(scope="module")
def blob():
    pb, out = prover.prove_to_bytes(3, 512, CONSTS)
    assert out == oracle.mimc(3, 512, CONSTS)
    return pb


@pytest.fixture(scope="module")
def ref_batch(blob):
    """The batch as the JAX package builds it (numpy): good, one copy per
    tamper site with one bit flipped, three more good copies."""
    base = jdevice.proof_tree(jwire.parse_proof(blob))

    def mutate(path):
        t = device.tree_map(lambda x: np.array(x), base)
        node = t
        for k in path[:-1]:
            node = node[k]
        flat = node[path[-1]].reshape(-1)
        flat[len(flat) // 2] ^= 1
        return t

    trees = [base] + [mutate(p) for p in SITES] + [base] * N_GOOD_TAIL
    return device.tree_map(np.asarray, jdevice.stack_proofs(trees))


@pytest.fixture(scope="module")
def port_verdicts(ref_batch):
    fn, tables = V.make_verifier(CFG, 3, device="cpu")
    assert isinstance(fn, torch.nn.Module)
    assert V.make_verifier(CFG, 3, device="cpu")[0] is fn          # memoized
    names = {n for n, _ in fn.named_buffers()}
    assert {"g2_powers", "z_table", "z2_table", "k_table",
            "level_moduli"} <= names
    return fn(device.tree_from_reference(ref_batch, "cpu"))


def test_port_verdicts_are_exact(port_verdicts):
    assert port_verdicts.dtype == torch.bool
    assert port_verdicts.tolist() == EXPECT


def test_port_equals_jax_verifier(ref_batch, port_verdicts):
    jfn, _ = JV.make_verifier(JCfg(log_steps=9), inp=3)
    want = np.asarray(jfn(jdevice.to_device(ref_batch)))
    assert want.tolist() == EXPECT
    np.testing.assert_array_equal(port_verdicts.numpy(), want)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_verifier_gives_the_same(ref_batch, port_verdicts, chunk):
    fn, _ = V.make_chunked_verifier(CFG, 3, chunk=chunk, device="cpu")
    got = fn(device.tree_from_reference(ref_batch, "cpu"))
    assert torch.equal(got, port_verdicts)


def test_chunked_verifier_rejects_ragged_batch(ref_batch):
    fn, _ = V.make_chunked_verifier(CFG, 3, chunk=5, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        fn(device.tree_from_reference(ref_batch, "cpu"))


def test_single_proof_without_batch_axis(blob):
    fn, _ = V.make_verifier(CFG, 3, device="cpu")
    tree = device.to_device(device.proof_tree(wire.parse_proof(blob)), "cpu")
    out = fn(tree)
    assert out.shape == () and bool(out)


def test_a_tampered_proof_leaves_its_neighbours_alone(ref_batch):
    """Every position of the batch in turn next to tampered ones: verdicts
    follow the proofs under a permutation of the batch."""
    perm = np.random.RandomState(0).permutation(len(EXPECT))
    shuffled = device.tree_map(lambda x: x[perm], ref_batch)
    fn, _ = V.make_verifier(CFG, 3, device="cpu")
    got = fn(device.tree_from_reference(shuffled, "cpu"))
    assert got.tolist() == [EXPECT[i] for i in perm]


@pytest.mark.parametrize("case,expect", [
    ("blob", True), ("trailing", True), ("truncated", False),
    ("flipped", False), ("empty", False), ("wrong_family", False)])
def test_verify_proof_bytes(blob, case, expect):
    flipped = bytearray(blob)
    flipped[110] ^= 1
    data = {"blob": blob, "trailing": blob + b"trailing",
            "truncated": blob[:1000], "flipped": bytes(flipped), "empty": b"",
            "wrong_family": blob}[case]
    log_steps = 11 if case == "wrong_family" else 9
    assert svt.verify_proof_bytes(data, inp=3, log_steps=log_steps,
                                  device="cpu") is expect


def test_wrong_input_rejects(blob):
    assert svt.verify_proof_bytes(blob, inp=4, log_steps=9,
                                  device="cpu") is False


# ---------------------------------------------------------------------------
# the unshared walk: every branch on its own to the root
# ---------------------------------------------------------------------------

GROUPS = ["fri0_col", "fri0_poly", "fri1_col", "fri1_poly", "fri2_col",
          "fri2_poly", "main", "lincomb"]


def test_unshared_verdicts_equal_the_shared_ones(ref_batch, port_verdicts):
    """shared_merkle=False on the batch the JAX verifier judged: the same
    verdicts, from a verifier memoized on its own."""
    fn, _ = V.make_verifier(CFG, 3, shared_merkle=False, device="cpu")
    assert V.make_verifier(CFG, 3, shared_merkle=False, device="cpu")[0] is fn
    assert V.make_verifier(CFG, 3, device="cpu")[0] is not fn
    got = fn(device.tree_from_reference(ref_batch, "cpu"))
    assert torch.equal(got, port_verdicts)
    chunked, _ = V.make_chunked_verifier(CFG, 3, chunk=8, shared_merkle=False,
                                         device="cpu")
    assert torch.equal(chunked(device.tree_from_reference(ref_batch, "cpu")),
                       port_verdicts)


@pytest.fixture(scope="module")
def padded_batch(ref_batch):
    """The batch plus one good proof whose main depth is one short at one
    branch, every witness array one zero level deeper than the depths: ragged
    by is_rectangular, and honest but for the proofs that were not."""
    short = device.tree_map(lambda x: np.array(x[0]), ref_batch)
    short["main"]["depth"][3] -= 1
    batch = device.tree_map(lambda a, b: np.concatenate([a, b[None]]),
                            ref_batch, short)

    def pad(w):
        return np.concatenate([w, np.zeros_like(w[..., :1, :])], axis=-2)

    batch["main"]["witness"] = pad(batch["main"]["witness"])
    batch["lincomb"]["witness"] = pad(batch["lincomb"]["witness"])
    for key in ("col_witness", "poly_witness"):
        batch["fri"][key] = [pad(w) for w in batch["fri"][key]]
    return batch


@pytest.fixture(scope="module")
def unshared_groups(padded_batch):
    """The unshared verifier's verdicts on the padded batch, and the operands
    and result of every group its verify_branches_groups calls walked."""
    calls = []
    real = M.verify_branches_groups
    names = ("root", "indices", "value", "sibling", "witness", "depth")

    def recording(groups):
        out = real(groups)
        calls.extend((tuple(g[k] for k in names), ok)
                     for g, ok in zip(groups, out))
        return out

    fn, _ = V.make_verifier(CFG, 3, shared_merkle=False, device="cpu")
    M.verify_branches_groups = recording
    try:
        verdicts = fn(device.tree_from_reference(padded_batch, "cpu"))
    finally:
        M.verify_branches_groups = real
    assert len(calls) == len(GROUPS)
    return verdicts, dict(zip(GROUPS, calls))


def test_padded_is_not_tampered(ref_batch, padded_batch, unshared_groups):
    """Padded proofs route to the unshared walk and keep their verdicts; the
    short-depth proof rejects, and only it; the shared walk rejects them all
    through its depth guard."""
    assert device.is_rectangular(ref_batch)
    assert not device.is_rectangular(padded_batch)
    verdicts, _ = unshared_groups
    assert verdicts.tolist() == EXPECT + [False]
    shared, _ = V.make_verifier(CFG, 3, device="cpu")
    assert not shared(device.tree_from_reference(padded_batch, "cpu")).any()


@pytest.mark.parametrize("group", GROUPS)
def test_group_walk_equals_jax_verify_branches(unshared_groups, group):
    """Each group's per-branch verdicts against the JAX package's
    verify_branches called eagerly on the same operands."""
    _, groups = unshared_groups
    (root, indices, value, sibling, witness, depth), got = groups[group]

    def j(t):
        return jnp.asarray(np.ascontiguousarray(t.numpy()).view(np.uint32)
                           if t.dtype == torch.int32
                           else t.numpy().astype(np.uint32))

    want, _ = JM.verify_branches(j(root), j(indices), j(value), j(sibling),
                                 j(witness), j(depth))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == indices.shape and got[0].all()
    if group == "main":
        assert not got[-1, 3] and got[-1].sum() == got.shape[-1] - 1


# ---------------------------------------------------------------------------
# the runtime-statement verifier
# ---------------------------------------------------------------------------

def _limbs(x):
    a = fp.ints_to_limbs(x) if isinstance(x, list) else fp.int_to_limbs(x)
    return torch.from_numpy(a.astype(np.int32))


@pytest.mark.parametrize("what,expect", [
    ("statement", EXPECT), ("wrong_output", None), ("wrong_input", None),
    ("changed_constant", None)])
def test_general_verifier(ref_batch, port_verdicts, what, expect):
    """Input, round constants and output as tensors: the static verifier's
    verdicts for the statement, and no proof accepted for another one."""
    fn, _ = V.make_general_verifier(CFG, device="cpu")
    assert V.make_general_verifier(CFG, device="cpu")[0] is fn
    out = oracle.mimc(3, 512, CONSTS)
    consts = list(CONSTS)
    if what == "changed_constant":
        consts[7] ^= 1
    got = fn(device.tree_from_reference(ref_batch, "cpu"),
             _limbs(4 if what == "wrong_input" else 3), _limbs(consts),
             _limbs(out + 1 if what == "wrong_output" else out))
    if expect is None:
        assert not got.any()
    else:
        assert got.tolist() == expect and torch.equal(got, port_verdicts)


def test_general_verifier_unshared_on_the_padded_batch(padded_batch):
    fn, _ = V.make_general_verifier(CFG, shared_merkle=False, device="cpu")
    got = fn(device.tree_from_reference(padded_batch, "cpu"), _limbs(3),
             _limbs(CONSTS), _limbs(oracle.mimc(3, 512, CONSTS)))
    assert got.tolist() == EXPECT + [False]


def test_general_verifier_refuses_another_constant_count(blob):
    fn, _ = V.make_general_verifier(CFG, device="cpu")
    tree = device.to_device(device.proof_tree(wire.parse_proof(blob)), "cpu")
    with pytest.raises(ValueError, match="constants_limbs"):
        fn(tree, _limbs(3), _limbs(CONSTS[:32]), _limbs(1))


def test_second_family_against_the_oracle():
    """log_steps=11 with 32 constants of another sequence cannot go through
    make_verifier (its K table is the default constants'), so the family with
    the default constants at 2^11 steps is checked: port == oracle on the good
    proof and on a flipped byte."""
    consts = [(i ** 7) ^ 42 for i in range(64)]
    pb, out = prover.prove_to_bytes(3, 2048, consts)
    proof, _ = oracle.parse_proof(pb)
    assert oracle.verify_mimc_proof(3, 2048, consts, out, proof,
                                    parity_guards=False)
    assert StarkConfig(log_steps=11).fri_levels == 4
    assert svt.verify_proof_bytes(pb, inp=3, log_steps=11, device="cpu") is True
    bad = bytearray(pb)
    bad[120] ^= 4
    bad_proof, _ = oracle.parse_proof(bytes(bad))
    try:
        oracle_ok = oracle.verify_mimc_proof(3, 2048, consts, out, bad_proof,
                                             parity_guards=False)
    except (AssertionError, ValueError, IndexError):
        oracle_ok = False
    assert oracle_ok is False
    assert svt.verify_proof_bytes(bytes(bad), inp=3, log_steps=11,
                                  device="cpu") is False
