"""Host->device staging of parsed proofs: trees of arrays + batch stacking.

A proof becomes a nested dict of uint32 numpy arrays (the Blake2s word view
only; field-limb views are derived on the device, see
ops.field.words_be_to_limbs).  All proofs of one statement family share
shapes, so a batch is the same tree with a leading axis.  to_device() turns
the tree into torch tensors: every word costs 4 bytes on the device and is
stored as the int32 with the same bit pattern (torch's uint32 has no
arithmetic on the CPU); kernels reinterpret the words as uint32_t.
"""

from __future__ import annotations

import numpy as np
import torch

from .wire import BranchGroup, ProofArrays, WireFormatError


def resolve_device(device=None) -> torch.device:
    """device=None means the card.  Asking for the card where there is none
    raises: no entry point carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions")
    return dev


def tree_map(fn, tree, *rest):
    """Apply fn leaf-wise over nested dicts/lists of arrays or tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _group_tree(g: BranchGroup) -> dict:
    return {
        "value": np.asarray(g.value_words),
        "sibling": np.asarray(g.sibling_words),
        "witness": np.asarray(g.witness_words),
        "depth": np.asarray(g.depths),      # per-branch (ragged ok)
    }


def proof_tree(p: ProofArrays) -> dict:
    """One proof -> tree of numpy uint32 arrays (no leading batch axis).

    FRI levels are stacked along a leading level axis EXCEPT the witness
    arrays, which stay per-level lists with their exact depths (each level's
    Merkle walk covers its own depth; cross-level padding would waste a
    fifth of all Blake2s compressions).  Value sizes must be uniform per
    group -- the constraint algebra slices fixed trace-column layouts, and the
    reference's behaviour on wrong-size values is a panic (= reject)."""
    lv = p.fri_levels
    if not lv:
        raise WireFormatError("proof has no FRI levels")
    for g in ([l.column for l in lv] + [l.poly for l in lv]
              + [p.main, p.lincomb]):
        if len(set(g.vsizes.tolist())) != 1:
            raise WireFormatError(
                "ragged value sizes do not fit the statement family's "
                "fixed trace layout")
    fri = {
        "root2": np.stack([np.asarray(l.root2_words) for l in lv]),
        "col_value": np.stack([np.asarray(l.column.value_words) for l in lv]),
        "col_sibling": np.stack([np.asarray(l.column.sibling_words) for l in lv]),
        "col_witness": [np.asarray(l.column.witness_words) for l in lv],
        "col_depth": np.stack([np.asarray(l.column.depths) for l in lv]),
        "poly_value": np.stack([np.asarray(l.poly.value_words) for l in lv]),
        "poly_sibling": np.stack([np.asarray(l.poly.sibling_words) for l in lv]),
        "poly_witness": [np.asarray(l.poly.witness_words) for l in lv],
        "poly_depth": np.stack([np.asarray(l.poly.depths) for l in lv]),
    }
    return {
        "merkle_root": np.asarray(p.merkle_root_words),
        "l_merkle_root": np.asarray(p.l_merkle_root_words),
        "fri": fri,
        "points": np.asarray(p.points_words),
        "main": _group_tree(p.main),
        "lincomb": _group_tree(p.lincomb),
    }


def is_rectangular(tree: dict) -> bool:
    """True when every branch group's depths equal its witness array depth.

    Rectangular proofs (everything the bundled prover emits) take the
    shared-path Merkle walk (ops/merkle.verify_groups_shared); ragged proofs
    (per-branch witness sizes, deserializer.rs:104-119, or witness arrays
    padded deeper than the depths) take the independent per-branch walk
    (ops/merkle.verify_branches, shared_merkle=False).  Works on single
    proofs and stacked batches of numpy trees."""
    def rect(depth, wit):
        return bool((np.asarray(depth) == wit.shape[-2]).all())

    fri = tree["fri"]
    return (rect(tree["main"]["depth"], tree["main"]["witness"])
            and rect(tree["lincomb"]["depth"], tree["lincomb"]["witness"])
            and all(rect(fri["col_depth"][..., l, :], w)
                    for l, w in enumerate(fri["col_witness"]))
            and all(rect(fri["poly_depth"][..., l, :], w)
                    for l, w in enumerate(fri["poly_witness"])))


def stack_proofs(trees: list) -> dict:
    """Stack single-proof trees into a batch tree with leading axis."""
    return tree_map(lambda *xs: np.stack(xs), trees[0], *trees[1:])


def replicate_proof(tree: dict, batch: int) -> dict:
    """Tile one proof tree to a batch (benchmarking/synthetic loads)."""
    return tree_map(
        lambda x: np.broadcast_to(x[None], (batch,) + x.shape).copy(), tree)


def to_tensor(x, device) -> torch.Tensor:
    """numpy uint32 array -> int32 tensor with the same bits on `device`."""
    a = np.ascontiguousarray(x)
    if a.dtype != np.uint32:
        raise TypeError(f"expected uint32 words or limbs, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32)).to(device)


def to_device(tree: dict, device=None) -> dict:
    """numpy uint32 tree -> int32 tensors (same bit patterns) on `device`."""
    dev = resolve_device(device)
    return tree_map(lambda x: to_tensor(x, dev), tree)


_TREE_KEYS = {"merkle_root", "l_merkle_root", "fri", "points", "main",
              "lincomb"}
_FRI_KEYS = {"root2", "col_value", "col_sibling", "col_witness", "col_depth",
             "poly_value", "poly_sibling", "poly_witness", "poly_depth"}
_GROUP_KEYS = {"value", "sibling", "witness", "depth"}


def tree_from_reference(tree_np: dict, device=None) -> dict:
    """The JAX package's proof tree (its proof_tree / stack_proofs output,
    handed over as numpy arrays) -> the port's tensors.  The two packages use
    one layout, so this checks the keys and converts the leaves."""
    if (set(tree_np) != _TREE_KEYS or set(tree_np["fri"]) != _FRI_KEYS
            or set(tree_np["main"]) != _GROUP_KEYS
            or set(tree_np["lincomb"]) != _GROUP_KEYS):
        raise ValueError("not a proof tree of the expected layout")
    dev = resolve_device(device)
    return tree_map(
        lambda x: to_tensor(np.asarray(x).astype(np.uint32, copy=False), dev),
        tree_np)
