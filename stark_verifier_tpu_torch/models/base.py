"""Statement-family interface."""

from __future__ import annotations

import numpy as np
import torch

from ..config import StarkConfig
from ..ops import field as F, mimc as mimc_ops
from ..proofio.device import resolve_device
from ..protocol import verify as V


class StatementFamily:
    """A proof statement family: fixes constraints, trace shape, proof shape.

    The protocol layer (protocol/verify.py) is parameterized by the family's
    StarkConfig (its `power` selects the transition constraint); a family
    names its config and hands out the verifiers built from it.  device=None
    means the card everywhere, as at the other entry points.
    """

    name: str

    def __init__(self, cfg: StarkConfig):
        self._cfg = cfg

    def config(self) -> StarkConfig:
        """The StarkConfig for this family."""
        return self._cfg

    def round_constants(self):
        """[num_constants, 16] uint32 limbs of the family's round constants
        (host array)."""
        return mimc_ops.round_constants_mimc(self._cfg.num_constants)

    def compute_output(self, inp: int, device=None):
        """The claimed trace output for input `inp` as [16] limbs on
        `device`: the MiMC scan on the device (ops/mimc.mimc; on the card
        one launch of the scan kernel), as the JAX families compute it."""
        cfg = self._cfg
        dev = resolve_device(device)
        consts = torch.from_numpy(
            self.round_constants().astype(np.int32)).to(dev)
        return mimc_ops.mimc(F.const(inp, dev), cfg.num_steps, consts,
                             power=cfg.power)

    def make_verifier(self, inp: int = 3, shared_merkle: bool = True,
                      device=None):
        """(module, tables): batched verifier for this family against the
        output of `inp` (protocol.verify.make_verifier)."""
        return V.make_verifier(self._cfg, inp=inp,
                               shared_merkle=shared_merkle, device=device)

    def make_general_verifier(self, shared_merkle: bool = True, device=None):
        """Runtime-parameter verifier (the reference's library boundary,
        lib.rs:99): see protocol.verify.make_general_verifier."""
        return V.make_general_verifier(self._cfg, shared_merkle=shared_merkle,
                                       device=device)
