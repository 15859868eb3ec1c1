"""PyTorch / CUDA port of the batched MiMC-STARK verifier.

A second package beside the JAX one (`stark_verifier_tpu`), sharing no code
with it: 256-bit field elements as 16 x 16-bit limb tensors at the public
functions, Blake2s on int32 word tensors, and six hand-written CUDA kernels
(csrc/) -- the shared-path and the independent Merkle walks, the FRI row
check, the constraint spot checks and the element-wise modular multiply --
built with nvcc at first use.  Entry points run on the card unless the
caller passes device="cpu", where the kernels' plain PyTorch versions run
instead.
"""

from .fp import MODULUS, EXTENSION_FACTOR  # noqa: F401

__version__ = "0.1.0"


def verify_proof_bytes(proof_bytes: bytes, inp: int = 3,
                       log_steps: int = 13, strict: bool = False,
                       device=None) -> bool:
    """Parse + verify one serialized proof; malformed input rejects.

    Library facade mirroring the reference verifier's entry point
    (src/lib.rs:99, plus main()'s parse / MiMC recompute, main.rs:199-227).
    Malformed or family-shape-mismatched proofs return False (the reference
    panics = reject); trailing bytes after the proof are tolerated like the
    reference (main.rs:204) unless strict.  A ragged proof (per-branch
    witness depths) takes the independent per-branch Merkle walk.
    device=None means the card.  For batched verification use
    protocol.verify.make_verifier directly.
    """
    from .config import StarkConfig
    from .profiling import span
    from .proofio import wire, device as dev_io
    from .protocol import verify as V

    dev = dev_io.resolve_device(device)
    cfg = StarkConfig(log_steps=log_steps, strict=strict)
    with span("entry", proofs=1):
        try:
            with span("entry.parse"):
                host_tree = dev_io.proof_tree(
                    wire.parse_and_validate(proof_bytes, cfg))
        except wire.WireFormatError:
            return False
        with span("entry.lookup") as sp:
            misses = V._make_verifier_cached.cache_info().misses if sp \
                else 0
            fn, _ = V.make_verifier(
                cfg, inp=inp, shared_merkle=dev_io.is_rectangular(host_tree),
                device=dev)
            if sp:
                sp.set(built=V._make_verifier_cached.cache_info().misses
                       > misses)
        with span("entry.h2d"):
            tree = dev_io.to_device(host_tree, dev)
        verdict = fn(tree)
        with span("entry.wait"):
            return bool(verdict.item())


def verify_mimc(inp, num_steps, round_constants, output, proofs,
                strict: bool = False, device=None):
    """Batched general verification -- the reference's library boundary
    (src/lib.rs:99 pub verify_mimc_proof taking (inp, num_steps,
    round_constants, output, proof, modulus)).

    inp/output: ints; round_constants: list of ints (len a power of two);
    proofs: one `bytes` or a list of serialized proofs (same statement
    family, so one call covers the batch).  The modulus is the fixed field
    prime (the limb arithmetic is specialized to it).  Returns a numpy bool
    array [len(proofs)] (scalar bool for one proof); malformed proofs reject
    instead of raising.  If any proof of the list is ragged, the whole list
    takes the independent per-branch Merkle walk.  device=None means the
    card.
    """
    import numpy as np
    from . import fp as _fp
    from .config import StarkConfig
    from .models.mimc import MimcStatement
    from .proofio import wire, device as dev_io

    dev = dev_io.resolve_device(device)
    single = isinstance(proofs, (bytes, bytearray))
    blobs = [proofs] if single else list(proofs)
    cfg = StarkConfig(log_steps=num_steps.bit_length() - 1,
                      num_constants=len(round_constants), strict=strict)
    if cfg.num_steps != num_steps:
        raise ValueError("num_steps must be a power of two")

    trees, ok_parse = [], []
    golden_shape = None
    for b in blobs:
        try:
            t = dev_io.proof_tree(wire.parse_and_validate(bytes(b), cfg))
            trees.append(t)
            ok_parse.append(True)
            golden_shape = t
        except wire.WireFormatError:
            trees.append(None)
            ok_parse.append(False)
    if golden_shape is None:
        out = np.zeros(len(blobs), dtype=bool)
        return bool(out[0]) if single else out
    trees = [t if t is not None else golden_shape for t in trees]
    shared = all(dev_io.is_rectangular(t) for t in trees)
    fn, _ = MimcStatement(cfg).make_general_verifier(shared_merkle=shared,
                                                     device=dev)
    batch = dev_io.to_device(dev_io.stack_proofs(trees), dev)

    def limbs(a):
        return dev_io.to_tensor(a, dev)

    verdicts = fn(
        batch,
        limbs(_fp.int_to_limbs(inp % MODULUS)),
        limbs(_fp.ints_to_limbs([c % MODULUS for c in round_constants])),
        limbs(_fp.int_to_limbs(output % MODULUS)),
    ).cpu().numpy()
    verdicts = verdicts & np.asarray(ok_parse)
    return bool(verdicts[0]) if single else verdicts
