"""The verifier modules' CUDA graphs (protocol/verify._CallGraphs) on the
CPU: a stand-in for the graph (CpuGraph: the capture runs the call once, a
replay runs it again into the same output tensor) drives the keying policy
(eager on the first call of a shape, captured on the second, replayed from
the third; eager off the card, with `part` and under STARK_DEBUG; the
oldest shape out past GRAPH_KEYS), the copies in and out of a replay, two
threads replaying one graph, and a module's verdicts; and the boundary
constants a module keeps equal the ones a call computes on the host.
log_steps=9 proofs from tests/prover.py."""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

import prover
from stark_verifier_tpu_torch import fp
from stark_verifier_tpu_torch.config import StarkConfig
from stark_verifier_tpu_torch.ops import field as F
from stark_verifier_tpu_torch.proofio import device as pdev, wire
from stark_verifier_tpu_torch.protocol import verify as V

torch.set_num_threads(1)
CONSTS = [(i ** 7) ^ 42 for i in range(64)]
CFG = StarkConfig(log_steps=9)


class CpuGraph(V._Graph):
    """_Graph with its capture and replay on the CPU."""

    def _capture(self, fn, args):
        self.fn, self.args = fn, args
        return fn(*args)

    def _replay(self):
        self.out.copy_(self.fn(*self.args))

    def _on_stream(self):
        return contextlib.nullcontext()


@pytest.fixture
def graphs(monkeypatch):
    """A fresh graph cache whose calls count as on the card, and the
    CpuGraph stand-in for the CUDA graph."""
    monkeypatch.setattr(V, "_on_card", lambda tree: True)
    monkeypatch.setattr(V, "_Graph", CpuGraph)
    monkeypatch.delenv("STARK_DEBUG", raising=False)
    return V._CallGraphs()


def _call(rows: int, fill: int = 1, pause: float = 0.0):
    """(fn, args): a toy call on a `rows`-row tree that reads it `pause`
    seconds after it starts, and how often fn ran."""
    ran = []

    def fn(tree, k, none):
        ran.append(1)
        time.sleep(pause)
        return tree["merkle_root"].sum(dim=-1) * k
    tree = {"merkle_root": torch.full((rows, 8), fill, dtype=torch.int32),
            "fri": [torch.arange(rows)]}
    return fn, (tree, 3, None), ran


def test_first_call_eager_second_captures_then_replays(graphs):
    fn, args, ran = _call(4)
    hows = []
    for fill in (1, 2, 3, 4):
        args[0]["merkle_root"].fill_(fill)
        out, how, graph = graphs(fn, args, "s")
        hows.append(how)
        assert out.tolist() == [24 * fill] * 4
        assert (graph is None) == (how == "eager")
    assert hows == ["eager", "capture", "replay", "replay"]
    # eager once, the capture's call and a replay's call of each later one
    assert len(ran) == 1 + 1 + 3
    # another shape, another static part or another host value: a new key
    for rows, static, k in ((5, "s", 3), (4, "t", 3), (4, "s", 7)):
        fn2, args2, _ = _call(rows)
        args2 = (args2[0], k, None)
        assert [graphs(fn2, args2, static)[1] for _ in range(3)] == [
            "eager", "capture", "replay"]


@pytest.mark.parametrize("why", ["off the card", "part", "STARK_DEBUG"])
def test_off_card_part_and_debug_run_eagerly(graphs, monkeypatch, why):
    part = None
    if why == "off the card":
        monkeypatch.setattr(V, "_on_card", lambda tree: False)
    elif why == "part":
        part = (0, 2)
    else:
        monkeypatch.setenv("STARK_DEBUG", "1")
    fn, args, ran = _call(4)
    for _ in range(4):
        out, how, graph = graphs(fn, args, "s", part)
        assert (how, graph) == ("eager", None)
    assert len(ran) == 4 and not graphs._keys


def test_the_least_recently_used_shape_goes_past_the_bound(graphs):
    calls = [_call(rows) for rows in range(1, V.GRAPH_KEYS + 2)]
    fn, args, _ = calls[0]
    assert [graphs(fn, args, "s")[1] for _ in range(2)] == ["eager",
                                                            "capture"]
    for fn2, args2, _ in calls[1:-1]:
        graphs(fn2, args2, "s")
    assert graphs(fn, args, "s")[1] == "replay"       # now the newest
    graphs(*calls[-1][:2], "s")                         # one shape too many
    assert graphs(*calls[1][:2], "s")[1] == "eager"     # the oldest went
    assert graphs(fn, args, "s")[1] == "replay"
    assert len(graphs._keys) == V.GRAPH_KEYS


def test_a_replay_leaves_the_verdicts_it_returned_before(graphs):
    fn, args, _ = _call(4)
    graphs(fn, args, "s")
    first, how, graph = graphs(fn, args, "s")
    assert how == "capture"
    args[0]["merkle_root"].fill_(5)
    second, how, _ = graphs(fn, args, "s")
    assert how == "replay"
    assert first.tolist() == [24] * 4 and second.tolist() == [120] * 4
    assert first.data_ptr() != graph.out.data_ptr() != second.data_ptr()
    # the static inputs are copies: the caller's tensors are never read
    # by a replay
    assert all(a.data_ptr() != b.data_ptr() for a, b in
               zip(graph.inputs, [args[0]["merkle_root"], args[0]["fri"][0]]))


def test_two_threads_replay_one_graph_each_on_its_own_inputs(graphs):
    """The static inputs and the verdicts are shared by every caller: a
    thread's copy-in must not land while another's replay reads them, nor
    a replay overwrite verdicts another has yet to copy out."""
    fn, args, _ = _call(4, pause=2e-4)
    for _ in range(2):                       # eager, then the capture
        graphs(fn, args, "s")
    wrong = []

    def caller(fill):
        _, mine, _ = _call(4, fill)
        for _ in range(100):
            out, how, _ = graphs(fn, mine, "s")
            if how != "replay" or out.tolist() != [24 * fill] * 4:
                wrong.append((fill, how, out.tolist()))

    threads = [threading.Thread(target=caller, args=(f,)) for f in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not wrong, wrong[:5]


@pytest.fixture(scope="module")
def batch():
    """A golden and a tampered proof as one batch tree on the CPU."""
    pb, out = prover.prove_to_bytes(3, 512, CONSTS)
    bad = bytearray(pb)
    bad[40] ^= 1                                   # inside l_merkle_root
    trees = [pdev.proof_tree(wire.parse_and_validate(bytes(b), CFG))
             for b in (pb, bad)]
    return pdev.to_device(pdev.stack_proofs(trees), "cpu"), out


def test_a_module_replays_the_eager_verdicts(graphs, batch, monkeypatch):
    tree, _ = batch
    fn, _ = V.make_verifier(CFG, inp=3, device="cpu")
    monkeypatch.setattr(fn, "graphs", graphs)
    before = V.graph_counts.copy()
    got = [fn(tree).tolist() for _ in range(3)]
    assert got == [[True, False]] * 3
    assert V.graph_counts - before == {("shared", "eager"): 1,
                                       ("shared", "capture"): 1,
                                       ("shared", "replay"): 1}


@pytest.mark.parametrize("inp", [3, 12345, "limbs"])
def test_the_modules_boundary_constants_are_the_hosts(batch, inp):
    """i_c0 and i_c1 from the module's constants equal, word for word, the
    ones each call computed on the host before they were kept."""
    _, out = batch
    m = CFG.modulus
    rng = np.random.default_rng(7)
    outs = [out] + [int.from_bytes(rng.bytes(32), "big") % m
                    for _ in range(3)]
    out_limbs = pdev.to_tensor(fp.ints_to_limbs(outs), "cpu")
    if inp == "limbs":
        mod, _ = V.make_general_verifier(CFG, device="cpu")
        x = pdev.to_tensor(fp.ints_to_limbs([3, 4, m - 1, 0]), "cpu")
    else:
        mod, _ = V.make_verifier(CFG, inp=inp, device="cpu")
        x = inp
    got = V.interpolant(x, out_limbs, V._module_boundary(mod, x))

    last = mod.last_step_position
    e0, e1 = (1 - last) % m, (last - 1) % m
    inv_e = pow(e0 * e1 % m, m - 2, m)
    iy1 = F.mul_mod(out_limbs, F.const(inv_e * e0 % m, "cpu"))
    neg_iy1 = F.mul_mod(F.const(m - 1, "cpu"), iy1)
    if isinstance(x, int):
        iy0 = x % m * inv_e % m * e1 % m
        want = (F.add_mod(F.const((-last * iy0) % m, "cpu"), neg_iy1),
                F.add_mod(F.const(iy0, "cpu"), iy1))
    else:
        iy0 = F.mul_mod(x, F.const(inv_e * e1 % m, "cpu"))
        want = (F.add_mod(F.mul_mod(iy0, F.const((-last) % m, "cpu")),
                          neg_iy1), F.add_mod(iy0, iy1))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert mod.boundary_inp == (None if inp == "limbs" else inp)
