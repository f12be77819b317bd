"""Each CUDA kernel of the port against its plain PyTorch version, on
the card (marker `cuda`; skipped where torch.cuda.is_available() is
False). Imports nothing of JAX, so it runs on a machine with a GPU and no
JAX:  PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m cuda

Each wrapper must launch its kernel (one counted launch), agree with its
plain version under kernels/parity.py's stated tolerances, and raise —
never fall back — on what its kernel does not take.
"""
import pytest
import torch

from repro_torch.data.synthetic import gen_images
from repro_torch.kernels import counters, ops
from repro_torch.kernels import fused_step as TF
from repro_torch.kernels import greedy_loop as TL
from repro_torch.kernels import pairwise as TP
from repro_torch.kernels import parity
from repro_torch.kernels import rules as TR

FEATURE_RULES = {
    "kmedoid": TR.DIST_MIN,
    "facility": TR.DOT_MAX,
    "satcover": TR.sat_sum(2.0),
    "graphcut": TR.graph_cut(0.5),
    "mmr": TR.mmr(0.3, 2.0),
}


def _pools(b=3, n=40, c=24, d=32, seed=0):
    x = gen_images(b * (n + c), d, classes=6, seed=seed)
    return x[:b * n].reshape(b, n, d), x[b * n:].reshape(b, c, d)


# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False on this machine")
    return torch.device("cuda")


def _dev_pools(cuda, b, n, c, d, seed):
    g, cd = _pools(b=b, n=n, c=c, d=d, seed=seed)
    return torch.as_tensor(g).to(cuda), torch.as_tensor(cd).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dot", "dist"])
@pytest.mark.parametrize("shape", [(2, 130, 70, 96), (1, 7, 5, 3)])
def test_cuda_pairwise_kernel_matches_plain(cuda, mode, shape):
    b, n, c, d = shape
    g, cd = _dev_pools(cuda, b, n, c, d, seed=5)
    counters.reset()
    got = TP.pairwise(g, cd, mode)
    assert counters.snapshot()["pairwise"]["launches"] == 1
    want = TP.pairwise_plain(g, cd, mode)
    parity.compare_pairwise(got, want, g, cd, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FEATURE_RULES))
def test_cuda_greedy_loop_kernel_matches_plain(cuda, name):
    tr = FEATURE_RULES[name]
    g, cd = _dev_pools(cuda, 3, 300, 90, 32, seed=6)
    mat = TP.pairwise_plain(g, cd, tr.pairwise).contiguous()
    valid = torch.ones(3, 300, dtype=torch.bool, device=cuda)
    row = TR.empty_row(g, valid, tr).contiguous()
    mask = torch.ones(3, 90, device=cuda)
    counters.reset()
    got = TL.greedy_loop(mat, row, mask, 12, tr, block_n=64)
    assert counters.snapshot()["greedy_loop"]["launches"] == 1
    want = TL.greedy_loop_plain(mat, row, mask, 12, tr)
    parity.compare_loops(got, want, tr)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FEATURE_RULES))
def test_cuda_resident_kernel_matches_plain(cuda, name):
    tr = FEATURE_RULES[name]
    _, cd = _dev_pools(cuda, 4, 1, 100, 48, seed=7)
    g = cd.clone()
    valid = torch.ones(4, 100, dtype=torch.bool, device=cuda)
    row = TR.empty_row(g, valid, tr).contiguous()
    mask = torch.ones(4, 100, device=cuda)
    ctl = torch.tensor([[10, 100, 100], [4, 100, 100]] * 2,
                       dtype=torch.int32, device=cuda)
    built = torch.empty(4, 100, 100, device=cuda)
    counters.reset()
    got = TL.greedy_loop_resident(g, cd, row, mask, ctl, 10, tr,
                                  scratch=built)
    assert counters.snapshot()["greedy_loop_resident"]["launches"] == 1
    # the resident build is the pairwise kernel's tile code
    assert torch.equal(built, TP.pairwise(g, cd, tr.pairwise))
    want = TL.greedy_loop_resident_plain(g, cd, row, mask, ctl, 10, tr)
    parity.compare_loops(got, want, tr, entry_diff=(
        built - TL.resident_matrix(g, cd, tr)).abs())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FEATURE_RULES))
@pytest.mark.parametrize("shape", [(3, 300, 130, 8), (2, 7, 5, 1)])
def test_cuda_fused_step_kernel_matches_plain(cuda, name, shape):
    """Fed the plain matrix: rows equal bit for bit, the gain within the
    reordering bound, the pick equal except at a rounding tie — over a
    random mask, for a first step (prev −1) and a later one."""
    tr = FEATURE_RULES[name]
    b, n, c, block_n = shape
    g, cd = _dev_pools(cuda, b, n, c, 24, seed=8)
    mat = TP.pairwise_plain(g, cd, tr.pairwise).contiguous()
    valid = torch.ones(b, n, dtype=torch.bool, device=cuda)
    row = TR.empty_row(g, valid, tr).contiguous()
    gen = torch.Generator(device=cuda).manual_seed(3)
    mask = (torch.rand(b, c, generator=gen, device=cuda) > 0.3).float()
    for prev in (torch.full((b,), -1, device=cuda),
                 torch.randint(0, c, (b,), generator=gen, device=cuda)):
        counters.reset()
        got = TF.fused_step(mat, row, mask, prev, tr, block_n=block_n)
        assert counters.snapshot()["fused_step"]["launches"] == 1
        want = TF.fused_step_plain(mat, row, mask, prev, tr)
        parity.compare_steps(got, want, mat, mask, tr)
    # every candidate masked: first index, −inf, as the plain version
    got = TF.fused_step(mat, row, torch.zeros_like(mask), prev, tr)
    assert bool((got[1] == 0).all()) and bool(torch.isinf(got[2]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FEATURE_RULES))
@pytest.mark.parametrize("shape", [(2, 150, 72, 200), (1, 5, 3, 7)])
def test_cuda_gains_kernel_matches_plain(cuda, name, shape):
    """Gain sums held to a float64 build under the pairwise ratio rule,
    −inf at the invalid candidates, on a live state row."""
    tr = FEATURE_RULES[name]
    b, n, c, d = shape
    g, cd = _dev_pools(cuda, b, n, c, d, seed=9)
    valid = torch.ones(b, n, dtype=torch.bool, device=cuda)
    row = TR.empty_row(g, valid, tr)
    for j in range(min(3, n)):
        row = TR.update_row(g, row, g[:, j], tr)
    row = row.contiguous()
    cand_valid = torch.arange(c, device=cuda).expand(b, c) % 5 != 1
    counters.reset()
    got = TP.gains(g, row, cd, cand_valid, tr)
    assert counters.snapshot()["gains"]["launches"] == 1
    want = TP.gains_plain(g, row, cd, cand_valid, tr)
    parity.compare_gains(got, want, g, row, cd, tr)


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    bits = torch.randint(0, 2 ** 31, (1, 8, 4), device=cuda)
    with pytest.raises(NotImplementedError):
        TL.greedy_loop_resident(None, bits, torch.zeros(1, 4, dtype=torch.int64,
                                                        device=cuda),
                                torch.ones(1, 8, device=cuda),
                                torch.tensor([[2, 4, 8]], dtype=torch.int32,
                                             device=cuda), 2, TR.BITS_OR)
    mat = torch.rand(1, 8, 8, device=cuda).to(torch.bfloat16)
    with pytest.raises(NotImplementedError):
        ops.greedy_loop(mat, torch.zeros(1, 8, device=cuda),
                        torch.ones(1, 8, device=cuda), 2, TR.DOT_MAX)
    with pytest.raises(NotImplementedError):
        ops.fused_step(mat, torch.zeros(1, 8, device=cuda),
                       torch.ones(1, 8, device=cuda),
                       torch.tensor([-1], device=cuda), TR.DOT_MAX)
    with pytest.raises(NotImplementedError):
        ops.gains(None, torch.zeros(1, 4, dtype=torch.int64, device=cuda),
                  bits, torch.ones(1, 8, dtype=torch.bool, device=cuda),
                  TR.BITS_OR)
