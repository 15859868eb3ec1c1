"""State carried across from the JAX package: statement tables and proof
trees are array-equal between the two packages, the port imports neither jax
nor the JAX package, and its entry points refuse to run on the CPU unless
asked to."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import prover
from stark_verifier_tpu.config import (
    StarkConfig as JCfg, StatementTables as JTables)
from stark_verifier_tpu.proofio import device as jdevice, wire as jwire
import stark_verifier_tpu_torch as svt
from stark_verifier_tpu_torch import config as C
from stark_verifier_tpu_torch.proofio import device, wire
from stark_verifier_tpu_torch.protocol import verify as V

torch.set_num_threads(1)
CONSTS = [(i ** 7) ^ 42 for i in range(64)]


@pytest.fixture(scope="module")
def blob():
    return prover.prove_to_bytes(3, 512, CONSTS)[0]


def _leaves(tree, prefix=()):
    """{path: leaf}: the two packages order dict keys differently."""
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


@pytest.mark.parametrize("log_steps", [9, 11])
def test_tables_equal_the_jax_packages(log_steps):
    cfg = C.StarkConfig(log_steps=log_steps)
    mine = C.StatementTables(cfg)
    ref = JTables(JCfg(log_steps=log_steps))
    for name in C._TABLE_ARRAYS:
        np.testing.assert_array_equal(getattr(mine, name),
                                      np.asarray(getattr(ref, name)), name)
    for name in C._TABLE_SCALARS + ("G2", "minipoly_root"):
        assert getattr(mine, name) == getattr(ref, name), name
    assert mine.level_moduli == ref.level_moduli
    assert cfg.fri_levels == JCfg(log_steps=log_steps).fri_levels
    assert cfg.fri_final_domain == JCfg(log_steps=log_steps).fri_final_domain


def test_tables_from_reference():
    cfg = C.StarkConfig(log_steps=9)
    ref = JTables(JCfg(log_steps=9))
    arrays = {n: np.asarray(getattr(ref, n)) for n in C._TABLE_ARRAYS}
    arrays.update({n: getattr(ref, n) for n in C._TABLE_SCALARS})
    got = C.tables_from_reference(arrays, cfg)
    mine = C.cached_tables(cfg)
    for name in C._TABLE_ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(mine, name))
    assert got.level_moduli == mine.level_moduli
    assert got.k_period == mine.k_period
    assert C.cached_tables(cfg) is mine                   # memoized
    arrays["z_table"] = arrays["z_table"][:-1]
    with pytest.raises(ValueError):
        C.tables_from_reference(arrays, cfg)


def test_default_tables_equal_the_jax_packages():
    from stark_verifier_tpu.config import default_tables as jax_default

    mine, ref = C.default_tables(), jax_default()
    assert mine is C.cached_tables(C.StarkConfig())       # memoized
    assert mine.cfg == C.StarkConfig() and mine.cfg.log_steps == 13
    for name in C._TABLE_ARRAYS:
        np.testing.assert_array_equal(getattr(mine, name),
                                      np.asarray(getattr(ref, name)), name)
    for name in C._TABLE_SCALARS + ("G2", "minipoly_root"):
        assert getattr(mine, name) == getattr(ref, name), name


def test_config_pins_extension_factor():
    with pytest.raises(ValueError):
        C.StarkConfig(extension_factor=4)
    assert C.StarkConfig().sanity_ok()


def test_proof_tree_equals_the_jax_packages(blob):
    mine = device.proof_tree(wire.parse_proof(blob))
    ref = jdevice.proof_tree(jwire.parse_proof(blob))
    a, b = _leaves(mine), _leaves(ref)
    assert set(a) == set(b) and len(a) == 24      # 3 FRI levels' witness lists
    for path, x in a.items():
        assert x.dtype == np.uint32, path
        np.testing.assert_array_equal(x, np.asarray(b[path]), str(path))
    assert wire.parse_proof(blob).consumed == jwire.parse_proof(blob).consumed
    assert device.is_rectangular(mine) and jdevice.is_rectangular(ref)


def test_tree_from_reference_and_stacking(blob):
    ref = jdevice.proof_tree(jwire.parse_proof(blob))
    ref_batch = jdevice.stack_proofs([ref, ref, ref])
    ref_np = device.tree_map(np.asarray, ref_batch)
    got = device.tree_from_reference(ref_np, "cpu")
    mine = device.proof_tree(wire.parse_proof(blob))
    want = device.to_device(device.stack_proofs([mine, mine, mine]), "cpu")
    rep = device.to_device(device.replicate_proof(mine, 3), "cpu")
    got_l, want_l, rep_l = _leaves(got), _leaves(want), _leaves(rep)
    assert set(got_l) == set(want_l) == set(rep_l)
    for path, x in got_l.items():
        assert x.dtype == torch.int32 and x.shape == want_l[path].shape, path
        assert torch.equal(x, want_l[path]) and torch.equal(x, rep_l[path])
    # bit patterns, not values: a word >= 2^31 comes across negative
    root = np.asarray(ref["merkle_root"])
    np.testing.assert_array_equal(
        got["merkle_root"][0].numpy().view(np.uint32), root)
    with pytest.raises(ValueError):
        device.tree_from_reference({"merkle_root": root}, "cpu")


@pytest.mark.parametrize("bad", ["truncated", "tag", "levels", "empty"])
def test_parser_error_model_matches(blob, bad):
    cfg, jcfg = C.StarkConfig(log_steps=9), JCfg(log_steps=9)
    data = {"truncated": blob[:1000], "tag": blob[:64] + b"\x07" + blob[65:],
            "levels": prover.prove_to_bytes(3, 128, CONSTS)[0],
            "empty": b""}[bad]
    with pytest.raises(wire.WireFormatError):
        wire.parse_and_validate(data, cfg)
    with pytest.raises(jwire.WireFormatError):
        jwire.validate_proof(jwire.parse_proof(data), jcfg)


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import stark_verifier_tpu_torch as s\n"
        "from stark_verifier_tpu_torch import _build, config, debug, fp\n"
        "from stark_verifier_tpu_torch.ops import (blake2s, field, fri_cuda,\n"
        "    merkle, merkle_cuda, mimc, ntt, prg, quartic, spot_cuda)\n"
        "from stark_verifier_tpu_torch.proofio import (device, ingest,\n"
        "    static_layout, wire)\n"
        "from stark_verifier_tpu_torch.protocol import verify\n"
        "from stark_verifier_tpu_torch import cli, native, profiling\n"
        "from stark_verifier_tpu_torch.parallel import mesh, ntt, rank_checks\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'jaxlib' or m.split('.')[0] == 'stark_verifier_tpu']\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean')\n")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # 6.1 s in a whole suite's run on six workers
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_entry_points_asked_for_the_card_raise_without_one(blob):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = C.StarkConfig(log_steps=9)
    with pytest.raises(RuntimeError, match="CUDA"):
        V.make_verifier(cfg, 3)                    # device=None means the card
    with pytest.raises(RuntimeError, match="CUDA"):
        V.make_chunked_verifier(cfg, 3, chunk=4, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        svt.verify_proof_bytes(blob, log_steps=9)
    with pytest.raises(RuntimeError, match="CUDA"):
        device.to_device(device.proof_tree(wire.parse_proof(blob)))


def test_kernel_build_raises_without_a_compiler(monkeypatch, tmp_path):
    """No nvcc: loading the kernels raises; nothing falls back."""
    from stark_verifier_tpu_torch import _build
    import shutil
    if shutil.which("nvcc"):
        pytest.skip("this machine has nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setitem(_build._state, "lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load()
    assert len(_build.source_hash()) == 16 and len(_build.sources()) == 8
