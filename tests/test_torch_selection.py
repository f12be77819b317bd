"""The port's coreset selection (`data/selection.py`) against the
reference's `src/repro/data/selection.py` on shared numpy inputs:
`parse_spec`, `embed_documents` and `synthetic.gen_embeddings` bit for
bit; `select_coreset` for 'none', 'greedy:', 'greedyml:', 'randgreedi:'
and 'stream:facility' on small-integer embeddings (exact arithmetic:
equal ids). On `gen_embeddings` the node grounds of b·k rows are full of
exact ties that rounding decides (ROADMAP §C P1), so there the port's
`select_coreset` is held to the port's simulator entry points it wraps,
which tests/test_torch_tree.py holds against the reference's stage by
stage up to float64-proven ties. The stream batch flag and its default,
the reference's 128. The mesh branch runs over spawned
ranks in tests/test_torch_distributed.py.
"""
import numpy as np
import pytest

from repro.data import selection as JSel
from repro.data import synthetic as JSyn
from repro.runtime import flags as JFlags
from repro_torch.core.simulate import run_greedy_dense, run_tree_dense
from repro_torch.core.tree import AccumulationTree, randgreedi_tree
from repro_torch.data import selection as TSel
from repro_torch.data import synthetic as TSyn
from repro_torch.runtime import flags as TFlags

K = 8


def _int_embeddings(n=256, d=16, seed=3):
    return np.random.default_rng(seed).integers(-3, 4, (n, d)).astype(
        np.float32)


@pytest.mark.parametrize("spec", ["none", "", "greedyml:facility",
                                  "randgreedi:kmedoid", "stream:",
                                  "greedy"])
def test_parse_spec_matches_reference(spec):
    assert TSel.parse_spec(spec) == JSel.parse_spec(spec)


@pytest.mark.parametrize("seed", [0, 4])
def test_embeddings_are_identical_copies(seed):
    toks = JSyn.gen_tokens(12, 20, 50, seed=seed)
    np.testing.assert_array_equal(TSel.embed_documents(toks, 32, seed),
                                  JSel.embed_documents(toks, 32, seed))
    np.testing.assert_array_equal(TSyn.gen_embeddings(40, 12, 5, seed),
                                  JSyn.gen_embeddings(40, 12, 5, seed))


def test_stream_batch_flag(monkeypatch):
    monkeypatch.delenv(TFlags.STREAM_BATCH_ENV, raising=False)
    monkeypatch.delenv(JFlags.STREAM_BATCH_ENV, raising=False)
    assert TFlags.stream_batch() == JFlags.stream_batch() == 128
    monkeypatch.setenv(TFlags.STREAM_BATCH_ENV, "64")
    assert TFlags.stream_batch() == 64 and JFlags.stream_batch() == 128
    monkeypatch.setenv(TFlags.STREAM_BATCH_ENV, "0")
    assert TFlags.stream_batch() == 1
    monkeypatch.setenv(TFlags.STREAM_BATCH_ENV, "x")
    assert TFlags.stream_batch() == 128


def _both(x, spec, **kw):
    want = np.asarray(JSel.select_coreset(x, K, spec, **kw))
    got = TSel.select_coreset(x, K, spec, device="cpu", **kw)
    return want, got


SPECS = ["greedy:facility", "greedyml:facility", "randgreedi:facility",
         "stream:facility", "greedyml:kmedoid"]


@pytest.mark.parametrize("spec", SPECS)
def test_select_coreset_matches_reference_on_exact_data(spec):
    x = _int_embeddings()
    want, got = _both(x, spec, machines=4, branching=2, seed=2)
    assert got.dtype.kind == "i" and len(got) <= K
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec", ["greedy:facility", "greedyml:facility",
                                  "randgreedi:kmedoid", "greedyml:kmedoid"])
def test_select_coreset_on_embeddings_is_the_simulator(spec):
    x = TSyn.gen_embeddings(256, 16, 10, seed=5)
    algo, name = TSel.parse_spec(spec)
    got = TSel.select_coreset(x, K, spec, machines=4, branching=2, seed=1,
                              device="cpu")
    if algo == "greedy":
        want = run_greedy_dense(name, x, K, device="cpu")
    else:
        tree = (randgreedi_tree(4) if algo == "randgreedi"
                else AccumulationTree(4, 2))
        want = run_tree_dense(name, x, K, tree, seed=1, device="cpu")
    np.testing.assert_array_equal(got, want.ids)


def test_select_coreset_none_and_errors():
    x = _int_embeddings(32)
    np.testing.assert_array_equal(TSel.select_coreset(x, K, "none"),
                                  np.arange(32))
    with pytest.raises(ValueError, match="embeddings"):
        TSel.select_coreset(x, K, "stream:kcover", device="cpu")


def test_select_coreset_stream_follows_the_batch_flag(monkeypatch):
    x = _int_embeddings()
    monkeypatch.setenv(TFlags.STREAM_BATCH_ENV, "32")
    monkeypatch.setenv(JFlags.STREAM_BATCH_ENV, "32")
    want, got = _both(x, "stream:facility", seed=4)
    np.testing.assert_array_equal(got, want)
    # an explicit batch overrides the flag
    np.testing.assert_array_equal(
        TSel.select_coreset(x, K, "stream:facility", seed=4, device="cpu",
                            stream_batch=32, stream_order="ordered"),
        np.asarray(JSel.select_coreset(x, K, "stream:facility", seed=4,
                                       stream_batch=32,
                                       stream_order="ordered")))
