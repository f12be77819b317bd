"""The two helpers the port took from the reference last, held against
it on shared numpy inputs: `data/synthetic.py::sets_stats` (exactly) and
`kernels/ref.py::pairwise_dist` / `pairwise_sim` (the reference's
‖x‖²+‖c‖²−2⟨x,c⟩ expansion and plain product, within 1e-5 of the
matrix's scale), batched alike over leading dimensions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as JSyn
from repro.kernels import ref as JRef
from repro_torch.data import synthetic as TSyn
from repro_torch.kernels import ref as TRef


@pytest.mark.parametrize("seed", [0, 3])
def test_sets_stats_matches_reference(seed):
    sets = JSyn.gen_kcover(300, 700, seed=seed, avg_size=9.0)
    assert TSyn.sets_stats(sets) == JSyn.sets_stats(sets)
    graph = JSyn.gen_graph_road(256, seed=seed)
    assert TSyn.sets_stats(graph) == JSyn.sets_stats(graph)
    mean, total = TSyn.sets_stats(sets)
    assert isinstance(mean, float) and isinstance(total, int)


def _points(n, c, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(c, d)).astype(np.float32))


@pytest.mark.parametrize("shape", [(64, 48, 16), (100, 7, 33), (1, 1, 1)])
@pytest.mark.parametrize("which", ["pairwise_dist", "pairwise_sim"])
def test_pairwise_helpers_match_reference(which, shape):
    g, c = _points(*shape, seed=sum(shape))
    want = np.asarray(getattr(JRef, which)(jnp.asarray(g), jnp.asarray(c)))
    got = getattr(TRef, which)(torch.as_tensor(g), torch.as_tensor(c))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
    # the same function as the port's rule primitives build the matrix by
    rule = "dist" if which == "pairwise_dist" else "dot"
    from repro_torch.kernels import rules as R
    assert torch.equal(got, R.pairwise_block(torch.as_tensor(g),
                                             torch.as_tensor(c), rule))


def test_pairwise_helpers_take_leading_dimensions_and_widen():
    g, c = _points(24, 10, 8, seed=5)
    gb = torch.as_tensor(np.stack([g, 2 * g]))
    cb = torch.as_tensor(np.stack([c, -c]))
    for which in ("pairwise_dist", "pairwise_sim"):
        fn = getattr(TRef, which)
        batched = fn(gb, cb)
        for i in range(2):
            assert torch.equal(batched[i], fn(gb[i], cb[i]))
        # bf16 inputs are widened to f32 first, as the reference's are
        half = fn(gb.to(torch.bfloat16), cb.to(torch.bfloat16))
        assert half.dtype == torch.float32
        want = np.asarray(getattr(JRef, which)(
            jnp.asarray(g, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16)))
        np.testing.assert_allclose(half[0].numpy(), want, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))
