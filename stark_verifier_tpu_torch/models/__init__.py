"""Statement families ("models") verifiable by the port.

A statement family fixes the AIR (transition/boundary constraints), the trace
parameters, and the proof shape; every proof of a family shares tensor
shapes, which is what makes batched verification possible.  The reference
supports exactly one family -- the MiMC permutation STARK
(src/main.rs:199-227) -- provided here as models.mimc; models.square is a
second one over the same proof machinery.
"""

from .base import StatementFamily  # noqa: F401
from . import mimc  # noqa: F401
from . import square  # noqa: F401

FAMILIES = {
    "mimc": mimc.MimcStatement,        # the reference's AIR (x^3 + k)
    "square": square.SquareStatement,  # second family (x^2 + k)
}
