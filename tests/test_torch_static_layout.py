"""Device-side deserialization of the port (proofio/static_layout.py)
against the JAX package's CanonicalLayout (run eagerly, no verifier
compile) and the host parser, on log_steps=9 proofs from tests/prover.py.
Tolerance 0 everywhere."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import prover
from stark_verifier_tpu.config import StarkConfig as JCfg
from stark_verifier_tpu.proofio import static_layout as JSL
from stark_verifier_tpu_torch.config import StarkConfig
from stark_verifier_tpu_torch.proofio import device, static_layout as SL, wire
from test_stream_independence import _synthetic_family_blob, _zero_level_proof

torch.set_num_threads(1)
CONSTS = [(i ** 7) ^ 42 for i in range(64)]


@pytest.fixture(scope="module")
def pb():
    return prover.prove_to_bytes(3, 512, CONSTS)[0]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, prefix + (k,)))
    return out


def _blobs(pb, jcfg):
    flip_last = pb[:-4] + b"\xff\xff\xff\xff"
    return {
        "golden": pb,
        "flipped_value": pb[:200] + bytes([pb[200] ^ 1]) + pb[201:],
        "trailing": pb + b"trail",
        "short_odd": pb[:999],
        "short_tail": pb[:-2],
        "empty": b"",
        "zero_levels": _zero_level_proof(),
        "synthetic_depth_1": _synthetic_family_blob(jcfg, 1),
        "zeros": b"\x00" * len(pb),
        "last_witness_word": flip_last,
        "wrong_tag": pb[:64] + b"\x07" + pb[65:],
    }


@pytest.mark.parametrize("log_steps", [9, 11, 13])
def test_layout_offsets_equal_jax(log_steps):
    mine = SL.CanonicalLayout(StarkConfig(log_steps=log_steps))
    ref = JSL.CanonicalLayout(JCfg(log_steps=log_steps))
    for name in ("col_depths", "poly_depths", "main_depth", "lin_depth",
                 "n_points", "levels", "points_tag_off", "points_off",
                 "main", "lincomb", "words", "nbytes"):
        assert getattr(mine, name) == getattr(ref, name), name
    assert SL.canonical_layout(StarkConfig(log_steps=log_steps)) is \
        SL.canonical_layout(StarkConfig(log_steps=log_steps))


def test_pack_equals_jax(pb):
    cfg, jcfg = StarkConfig(log_steps=9), JCfg(log_steps=9)
    lay, jlay = SL.canonical_layout(cfg), JSL.canonical_layout(jcfg)
    assert lay.nbytes == len(pb)
    blobs = list(_blobs(pb, jcfg).values())
    buf, lens = lay.pack(blobs)
    jbuf, jlens = jlay.pack(blobs)
    assert buf.dtype == torch.int32 and tuple(buf.shape) == jbuf.shape
    np.testing.assert_array_equal(buf.numpy().view(np.uint32), jbuf)
    np.testing.assert_array_equal(lens, jlens)
    # into a reused, larger buffer: only the first rows are written
    out = torch.full((len(blobs) + 2, lay.words), -1, dtype=torch.int32)
    buf2, lens2 = lay.pack(blobs, out=out)
    assert buf2 is out
    np.testing.assert_array_equal(out[:len(blobs)].numpy().view(np.uint32),
                                  jbuf)
    assert (out[len(blobs):] == -1).all() and lens2.tolist() == lens.tolist()


def test_parse_equals_jax_and_the_host_tree(pb):
    cfg, jcfg = StarkConfig(log_steps=9), JCfg(log_steps=9)
    lay, jlay = SL.canonical_layout(cfg), JSL.canonical_layout(jcfg)
    named = _blobs(pb, jcfg)
    buf, _ = lay.pack(list(named.values()))
    tree, shape_ok = lay.parse(buf)
    jtree, jshape_ok = jlay.parse(jnp.asarray(buf.numpy().view(np.uint32)))
    assert shape_ok.dtype == torch.bool
    assert shape_ok.tolist() == np.asarray(jshape_ok).tolist()
    # a blob cut inside its last witness keeps every shape lane: only its
    # length shows it short, which is why short blobs always reroute
    assert dict(zip(named, shape_ok.tolist())) == {
        "golden": True, "flipped_value": True, "trailing": True,
        "short_odd": False, "short_tail": True, "empty": False,
        "zero_levels": False, "synthetic_depth_1": False, "zeros": False,
        "last_witness_word": True, "wrong_tag": False}
    mine, ref = _leaves(tree), _leaves(jtree)
    assert set(mine) == set(ref)
    for path, x in mine.items():
        assert x.dtype == torch.int32, path
        assert x.stride() == torch.empty(x.shape).stride(), path
        np.testing.assert_array_equal(x.numpy().view(np.uint32),
                                      np.asarray(ref[path]), str(path))
    # a canonical row is exactly the host parser's tree
    host = _leaves(device.to_device(device.proof_tree(wire.parse_proof(pb)),
                                    "cpu"))
    assert set(host) == set(mine)
    for path, x in host.items():
        assert torch.equal(mine[path][0], x), path
    # one row alone (a stream's last chunk may hold one): every leaf has the
    # canonical strides the kernels take, not the row's
    one, ok1 = lay.parse(buf[:1])
    assert ok1.tolist() == [True]
    for path, x in _leaves(one).items():
        assert x.stride() == torch.empty(x.shape).stride(), path
        assert torch.equal(x[0], host[path]), path


def test_blob_verifier_on_the_cpu(pb):
    cfg = StarkConfig(log_steps=9)
    fn, lay = SL.make_blob_verifier(cfg, device="cpu")
    flip = pb[:110] + bytes([pb[110] ^ 1]) + pb[111:]
    buf, _ = lay.pack([pb, flip, pb[:500], pb + b"x"])
    verdict, shape_ok = fn(buf)
    assert verdict.tolist() == [True, False, False, True]
    assert shape_ok.tolist() == [True, True, False, True]
    assert SL.make_blob_verifier(cfg, device="cpu")[0] is fn   # memoized


def test_blob_verifier_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        SL.make_blob_verifier(StarkConfig(log_steps=9))
