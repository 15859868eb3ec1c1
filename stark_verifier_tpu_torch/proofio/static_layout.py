"""Device-side static-layout deserialization: raw wire blobs -> verdicts.

For a rectangular statement family every byte offset of the serialized proof
is a constant: the wire format (src/deserializer.rs:16-144) nests fixed
branch counts, fixed 32/96-byte values, and per-level witness depths that are
functions of the family geometry.  So instead of parsing on the host, each
blob is packed as ONE contiguous row of words ([chunk, words] int32 holding
the uint32 bits, pinned when bound for the card), copied to the card in one
piece, and the proof tree is built there from views and copies.  Every wire
field is 4-byte aligned (all sizes are multiples of 32 plus u32 prefixes), so
the word view needs no byte shuffling; values stay in the Blake2s LE-word view
the verifier reads.

Tag / count / size sanity becomes one gather and compare into a per-proof
`shape_ok`: a blob that is not a canonical-layout proof of this family
reports shape_ok=False and the caller reroutes it through the host parser (it
may still be a valid proof with non-canonical witness padding -- the fast
path never decides such a verdict).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import StarkConfig
from .device import resolve_device


class CanonicalLayout:
    """Static word-offset map of the canonical rectangular wire blob for a
    statement family, plus the device parser built from it."""

    def __init__(self, cfg: StarkConfig):
        self.cfg = cfg
        log_p = cfg.precision.bit_length() - 1
        q, s, L = cfg.fri_queries, cfg.spot_checks, cfg.fri_levels
        self.col_depths = [log_p - 2 * l - 3 for l in range(L)]
        self.poly_depths = [log_p - 2 * l - 1 for l in range(L)]
        self.main_depth = self.lin_depth = log_p - 1
        self.n_points = cfg.fri_final_domain
        if min(self.col_depths) < 1:
            raise ValueError("family too small for the canonical layout")

        off = 16                     # merkle_root[0:8] l_merkle_root[8:16]
        self.levels = []             # (tag_off, root2_off, col_group, poly_group)

        def group(n, vw, d):
            nonlocal off
            g = {"n_off": off, "start": off + 1, "n": n, "vw": vw, "d": d,
                 "rec": 1 + 2 * vw + 1 + 8 * d}
            off += 1 + n * g["rec"]
            return g

        for l in range(L):
            tag_off, root2_off = off, off + 1
            off += 9
            cg = group(q, 8, self.col_depths[l])
            pg = group(4 * q, 8, self.poly_depths[l])
            self.levels.append((tag_off, root2_off, cg, pg))
        self.points_tag_off = off
        self.points_off = off + 2
        off += 2 + 8 * self.n_points
        self.main = group(2 * s, 24, self.main_depth)
        self.lincomb = group(s, 8, self.lin_depth)
        self.words = off
        self.nbytes = 4 * off
        self._check_idx, self._check_want = self._checks()
        self._on_device = {}         # device -> (index, expected) tensors

    def _checks(self):
        """Every word the shape lanes compare, and its expected value: each
        level's tag, every group's branch count, every record's value-size
        and witness-size prefix, the POINTS tag and size."""
        idx, want = [], []

        def eq(at, v):
            idx.append(np.asarray(at, dtype=np.int64).ravel())
            want.append(np.full(idx[-1].size, v, dtype=np.uint32))

        def group(g):
            eq(g["n_off"], g["n"])
            rec0 = g["start"] + g["rec"] * np.arange(g["n"])
            eq(rec0, 4 * g["vw"])
            eq(rec0 + 1 + 2 * g["vw"], 32 * g["d"])

        for tag_off, _root2_off, cg, pg in self.levels:
            eq(tag_off, 1)
            group(cg)
            group(pg)
        eq(self.points_tag_off, 2)
        eq(self.points_tag_off + 1, 32 * self.n_points)
        group(self.main)
        group(self.lincomb)
        return np.concatenate(idx), np.concatenate(want)

    def _check_tensors(self, device):
        key = str(device)
        t = self._on_device.get(key)
        if t is None:
            t = (torch.from_numpy(self._check_idx).to(device),
                 torch.from_numpy(self._check_want.view(np.int32)).to(device))
            self._on_device[key] = t
        return t

    # -- device parser ------------------------------------------------------

    def parse(self, words: torch.Tensor):
        """words [B, self.words] int32 (uint32 bits) -> (proof tree,
        shape_ok [B] bool), on the words' device.

        The tree has exactly the structure and dtypes of
        proofio.device.to_device(proof_tree(...)) for a canonical proof, and
        every leaf is dense (the kernels read proofs at one stride), so the
        verifier takes it unchanged.  Each leaf is one copy (a stacked leaf
        one `torch.stack`, a depth array one fill a level) and the shape
        lanes are one gather, compare and reduction: 4 L + 19 operations for
        L FRI levels.  shape_ok False means 'not a canonical blob of this
        family', NOT 'invalid proof'."""
        B = words.shape[0]

        def dense(t):
            # always a copy with canonical strides: a [1, ...] view of a
            # single row counts as contiguous, but its proof stride is still
            # the row's, which the kernels refuse
            return t.clone(memory_format=torch.contiguous_format)

        def parse_group(g):
            region = words[:, g["start"]:g["start"] + g["n"] * g["rec"]].view(
                B, g["n"], g["rec"])
            vw = g["vw"]
            return {
                "value": region[:, :, 1:1 + vw],
                "sibling": region[:, :, 1 + vw:1 + 2 * vw],
                "witness": dense(region[:, :, 2 + 2 * vw:]).view(
                    B, g["n"], g["d"], 8),
            }

        def depths(ds, n):
            out = words.new_empty((B, len(ds), n))
            for l, d in enumerate(ds):
                out[:, l].fill_(d)
            return out

        def branch_group(g):
            t = parse_group(g)
            return {"value": dense(t["value"]),
                    "sibling": dense(t["sibling"]),
                    "witness": t["witness"],
                    "depth": words.new_full((B, g["n"]), g["d"])}

        cols = [parse_group(cg) for _, _, cg, _ in self.levels]
        polys = [parse_group(pg) for _, _, _, pg in self.levels]
        q, q4 = self.levels[0][2]["n"], self.levels[0][3]["n"]
        tree = {
            "merkle_root": dense(words[:, 0:8]),
            "l_merkle_root": dense(words[:, 8:16]),
            "fri": {
                "root2": torch.stack([words[:, r:r + 8]
                                      for _, r, _, _ in self.levels], 1),
                "col_value": torch.stack([g["value"] for g in cols], 1),
                "col_sibling": torch.stack([g["sibling"] for g in cols], 1),
                "col_witness": [g["witness"] for g in cols],
                "col_depth": depths(self.col_depths, q),
                "poly_value": torch.stack([g["value"] for g in polys], 1),
                "poly_sibling": torch.stack([g["sibling"] for g in polys], 1),
                "poly_witness": [g["witness"] for g in polys],
                "poly_depth": depths(self.poly_depths, q4),
            },
            "points": dense(words[:, self.points_off:
                                  self.points_off + 8 * self.n_points]).view(
                B, self.n_points, 8),
            "main": branch_group(self.main),
            "lincomb": branch_group(self.lincomb),
        }
        idx, want = self._check_tensors(words.device)
        shape_ok = (words.index_select(1, idx) == want).all(dim=1)
        return tree, shape_ok

    # -- host packing -------------------------------------------------------

    def pack(self, blobs: list, out: torch.Tensor | None = None):
        """Pack wire blobs into the first len(blobs) rows of a [n, words]
        int32 buffer (reusable across chunks; pinned when the caller made it
        so), with the native parser's svt_pack_many on four threads.
        Returns (buf, lens [len(blobs)] int64 byte lengths).

        Long blobs truncate to the canonical prefix (the reference tolerates
        trailing garbage, main.rs:204; strict mode reroutes lens != nbytes to
        the host parser).  Short blobs zero-pad, but callers MUST reroute
        every lens < nbytes blob to the host parser in ALL modes: the shape
        lanes usually catch truncation, except when the missing trailing
        bytes happened to be zero -- the zero padding would silently
        reconstruct the full proof the host parser rejects as truncated."""
        from .. import native
        if out is None:
            out = torch.zeros((len(blobs), self.words), dtype=torch.int32)
        if (out.dtype != torch.int32 or out.dim() != 2
                or out.shape[1] != self.words or not out.is_contiguous()):
            raise ValueError(f"pack buffer must be dense [n, {self.words}] "
                             "int32")
        chunk = native.Blobs(blobs)
        native.pack_many(native.get_lib(), chunk, out.numpy())
        return out, chunk.lens.astype(np.int64)


@functools.lru_cache(maxsize=8)
def canonical_layout(cfg: StarkConfig) -> CanonicalLayout:
    return CanonicalLayout(cfg)


def make_blob_verifier(cfg: StarkConfig | None = None, inp: int = 3,
                       device=None):
    """fn(words [B, layout.words] int32 on the device) -> (verdict [B],
    shape_ok [B]): deserialization on the device, then the shared-path
    verifier.  Returns (fn, layout).

    verdict is already ANDed with shape_ok; callers MUST reroute through the
    host parser (a) shape_ok=False rows (may be non-canonical-but-valid
    proofs), (b) every row whose blob was SHORTER than layout.nbytes
    regardless of shape_ok (pack()'s zero padding can silently reconstruct a
    truncated proof whose missing tail bytes were zero), and (c) under strict
    cfg, every row with length != layout.nbytes (trailing bytes are
    invisible to the packed prefix).  device=None means the card.  Memoized
    like protocol.verify.make_verifier."""
    return _make_blob_verifier_cached(cfg or StarkConfig(), inp,
                                      str(resolve_device(device)))


@functools.lru_cache(maxsize=8)
def _make_blob_verifier_cached(cfg: StarkConfig, inp: int, device: str):
    from ..protocol import verify as V
    with V._build_span(cfg, True):
        lay = canonical_layout(cfg)
        # one chunk a call: the chunked verifier at chunk = the call's batch
        inner, _tables = V.make_verifier(cfg, inp, shared_merkle=True,
                                         device=device)

    def fn(words):
        tree, shape_ok = lay.parse(words)
        return inner(tree) & shape_ok, shape_ok

    return fn, lay
