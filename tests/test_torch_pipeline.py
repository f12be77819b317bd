"""The port's token corpus and batch pipeline (`repro_torch/data/
{synthetic,pipeline}.py`) against the reference's, bit for bit: the same
Zipf corpus, and the same batches at every step — over the whole corpus
and over a selected coreset, across the permutation's wrap-around and
its reseeding every n / global_batch steps. The first two cases mirror
`tests/test_pipeline.py`."""
import numpy as np
import pytest
import torch

from repro.data import pipeline as JP
from repro.data import synthetic as JS

from repro_torch.data import pipeline, synthetic


@pytest.mark.parametrize("n,seq,vocab,seed", [(64, 17, 100, 1),
                                              (512, 513, 151_936, 0)])
def test_gen_tokens_equals_reference(n, seq, vocab, seed):
    got = synthetic.gen_tokens(n, seq, vocab, seed=seed)
    want = JS.gen_tokens(n, seq, vocab, seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 1 and got.max() < vocab


@pytest.mark.parametrize("selected", [None, "coreset"])
@pytest.mark.parametrize("gb", [4, 7, 8])
def test_batches_equal_reference_across_the_wrap(selected, gb):
    toks = synthetic.gen_tokens(50, 17, 100, seed=2)
    sel = None
    if selected:
        sel = np.random.default_rng(9).choice(50, 13, replace=False)
    ds = pipeline.TokenDataset(toks, seed=3, selected=sel)
    ref = JP.TokenDataset(toks, seed=3, selected=sel)
    # enough steps for several reseedings and wrap-arounds
    for step in range(0, 4 * ds.n // gb + 5):
        got, want = ds.batch(step, gb), ref.batch(step, gb)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(step))


def test_place_puts_int64_ids_on_the_device():
    toks = synthetic.gen_tokens(16, 9, 50, seed=0)
    b = pipeline.place(pipeline.TokenDataset(toks).batch(0, 4),
                       device="cpu")
    assert b["tokens"].dtype == torch.int64 and b["tokens"].shape == (4, 8)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_dataset_batches_deterministic_and_resumable():
    toks = synthetic.gen_tokens(64, 17, 100, seed=1)
    ds = pipeline.TokenDataset(toks, seed=0)
    b1 = ds.batch(5, 8)
    b2 = ds.batch(5, 8)  # resume = recompute
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


def test_selected_subset_respected():
    toks = synthetic.gen_tokens(64, 17, 100, seed=1)
    ds = pipeline.TokenDataset(toks, seed=0,
                               selected=np.asarray([3, 5, 7, 11]))
    assert ds.n == 4
    b = ds.batch(0, 4)
    rows = {tuple(r) for r in b["tokens"].tolist()}
    allowed = {tuple(toks[i, :-1].tolist()) for i in [3, 5, 7, 11]}
    assert rows <= allowed
