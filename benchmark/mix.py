"""The benchmark's one traffic generator.

A traffic mix is a data file (`traffic/<name>.json`) of parameters; this
module turns it, the configuration's proofs and a seed into an endless
sequence of requests.  A request is a plain tuple `(kind, statement, a, b)`.
Each kind is a module `kinds/<kind>.py`, found by its name, that draws the
request's choices and gives its bytes and statement (`kinds/honest.py`
says how); a mix that needs a new kind adds a module there.

Every block of `sum(block.values())` requests holds each kind exactly as
often as the mix's `block` says, in an order drawn from the seed, so every
seed asks for the same work.  The seed also draws each request's
statement, flipped bit or moved output.  Honest requests cycle through
`ring` distinct copies of each proof, so no two requests of one chunk are
one object.
"""

from __future__ import annotations

import functools
import random

from . import found


@functools.lru_cache(maxsize=None)
def kind(name: str):
    return found.load_module("kinds", name)


def content_key(req: tuple) -> tuple:
    """A request with the same bytes and statement as `req`: requests with
    equal keys are judged once."""
    key = getattr(kind(req[0]), "key", None)
    return key(req) if key else req


def shares_content(req: tuple) -> bool:
    """Is the request's content shared by other requests of its key?"""
    return hasattr(kind(req[0]), "key")


class Mix:
    """The requests of one run, and the bytes and statement of each."""

    def __init__(self, traffic: dict, proofs, seed: int):
        self.traffic = traffic
        self.block = {k: int(v) for k, v in traffic["block"].items()}
        self.kinds = {k: kind(k) for k in self.block}
        self.proofs = proofs
        self.statements = len(proofs.inputs)
        self.rng = random.Random(seed)
        per = max(1, int(traffic.get("ring", 1)) // self.statements)
        # distinct copies of each honest proof: bytes(memoryview) copies
        self.ring = [[bytes(memoryview(b)) for _ in range(per)]
                     for b in proofs.blobs]
        self.drawn = dict.fromkeys(self.block, 0)
        for mod in self.kinds.values():
            if hasattr(mod, "prepare"):
                mod.prepare(self)

    def next_block(self) -> list:
        reqs = []
        for name, count in self.block.items():
            for _ in range(count):
                reqs.append(self.kinds[name].draw(self, self.rng,
                                                  self.drawn[name]))
                self.drawn[name] += 1
        self.rng.shuffle(reqs)
        return reqs

    def requests(self):
        """The endless request sequence."""
        while True:
            yield from self.next_block()

    def blob(self, req: tuple) -> bytes:
        return kind(req[0]).blob(self, req)

    def own_statement(self, s: int) -> tuple:
        return self.proofs.inputs[s], self.proofs.outputs[s]

    def statement(self, req: tuple) -> tuple:
        """(input, claimed output) of the request's statement."""
        f = getattr(kind(req[0]), "statement", None)
        return f(self, req) if f else self.own_statement(req[1])
