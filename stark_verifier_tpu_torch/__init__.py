"""PyTorch / CUDA port of the batched MiMC-STARK verifier.

A second package beside the JAX one (`stark_verifier_tpu`), sharing no code
with it: 256-bit field elements as 16 x 16-bit limb tensors at the public
functions, Blake2s on int32 word tensors, and four hand-written CUDA kernels
(csrc/) for the Merkle walks, the FRI row check and the constraint spot
checks, built with nvcc at first use.  Entry points run on the card unless
the caller passes device="cpu", where the kernels' plain PyTorch versions run
instead.
"""

from .fp import MODULUS, EXTENSION_FACTOR  # noqa: F401

__version__ = "0.1.0"


def verify_proof_bytes(proof_bytes: bytes, inp: int = 3,
                       log_steps: int = 13, device=None) -> bool:
    """Parse + verify one serialized proof; malformed input rejects.

    Library facade mirroring the reference verifier's entry point
    (src/lib.rs:99, plus main()'s parse / MiMC recompute, main.rs:199-227).
    Malformed or family-shape-mismatched proofs return False (the reference
    panics = reject); trailing bytes after the proof are tolerated like the
    reference (main.rs:204).  device=None means the card.  For batched
    verification use protocol.verify.make_verifier directly.
    """
    from .config import StarkConfig
    from .proofio import wire, device as dev_io
    from .protocol import verify as V

    dev = dev_io.resolve_device(device)
    cfg = StarkConfig(log_steps=log_steps)
    try:
        host_tree = dev_io.proof_tree(wire.parse_and_validate(proof_bytes, cfg))
    except wire.WireFormatError:
        return False
    if not dev_io.is_rectangular(host_tree):
        raise NotImplementedError(
            "ragged proofs (per-branch witness depths) need the masked "
            "lockstep walk (ROADMAP.md queue 1: kernel F with ragged proofs)")
    fn, _ = V.make_verifier(cfg, inp=inp, device=dev)
    return bool(fn(dev_io.to_device(host_tree, dev)).item())
