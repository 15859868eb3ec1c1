"""The benchmark's own walk of the proof wire format: where each protocol
site lies in a serialized proof.

The traffic flips one bit inside a site to make an invalid proof.  The walk
follows the wire format of jwasinger/stark-verifier (src/deserializer.rs:
two roots, FRI elements tagged MERKLE (1) until the POINTS element (2),
then the main and the linear-combination multiproofs) and shares no code
with the port's parser.  Only the data bytes of a site are listed, never a
tag, a count or a size, so a flip changes what a proof says and not how it
parses.
"""

from __future__ import annotations

# the twelve protocol sites a flip lands in
SITES = (
    "merkle_root", "l_merkle_root", "root2",
    "col_value", "col_sibling", "col_witness",
    "poly_value", "poly_witness",
    "main_value", "main_witness",
    "lincomb_value", "lincomb_sibling",
)


def site_ranges(blob: bytes) -> dict:
    """{site: [(start, end), ...]} byte ranges of every site of SITES.

    Raises ValueError where the blob is not a whole proof."""
    ranges = {s: [] for s in SITES}
    off = 0

    def add(site, n):
        nonlocal off
        if site in ranges and n:
            ranges[site].append((off, off + n))
        off += n

    def u32():
        nonlocal off
        if off + 4 > len(blob):
            raise ValueError("proof ends inside a length field")
        v = int.from_bytes(blob[off:off + 4], "little")
        off += 4
        return v

    def multiproof(prefix):
        for _ in range(u32()):
            vsize = u32()
            add(f"{prefix}_value", vsize)
            add(f"{prefix}_sibling", vsize)
            add(f"{prefix}_witness", u32())

    add("merkle_root", 32)
    add("l_merkle_root", 32)
    while True:
        tag = u32()
        if tag == 1:
            add("root2", 32)
            multiproof("col")
            multiproof("poly")
        elif tag == 2:
            add("points", u32())
            break
        else:
            raise ValueError(f"invalid proof element type {tag}")
    multiproof("main")
    multiproof("lincomb")
    if off > len(blob):
        raise ValueError("proof ends inside a site")
    return ranges


def site_sizes(ranges: dict) -> dict:
    """{site: number of data bytes}."""
    return {s: sum(b - a for a, b in r) for s, r in ranges.items()}


def byte_at(ranges: dict, site: str, k: int) -> int:
    """The offset of the k-th data byte of a site (0 <= k < its size)."""
    for a, b in ranges[site]:
        if k < b - a:
            return a + k
        k -= b - a
    raise IndexError(f"{site} has no byte {k}")


def flip(blob: bytes, offset: int, bit: int) -> bytes:
    """A copy of the blob with one bit flipped."""
    out = bytearray(blob)
    out[offset] ^= 1 << bit
    return bytes(out)
