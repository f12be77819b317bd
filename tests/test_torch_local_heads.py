"""`transformer._local_heads` over a mesh of 4 gloo ranks against the
same attention on one device, forward and backward: the query heads
split on "model" where the key heads do not divide it (each rank takes
the key head its query heads read, its gradient summed over the model
ranks), over "model" beside a batch split on "data", and whole where a
group of query heads would straddle two ranks."""
import pytest
import torch

from repro_torch.launch.spawn import run_ranks
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

# (data, model, query heads, key heads, query heads split on "model")
CASES = {"one_kv_head_a_rank": (1, 4, 4, 2, True),
         "kv_heads_over_data_and_model": (2, 2, 8, 1, True),
         "groups_straddle_ranks": (1, 4, 12, 3, False)}
B, S, D = 2, 8, 4


def _inputs(h, hk, decode):
    g = torch.Generator().manual_seed(h * 10 + hk)
    q = torch.randn(B, 1 if decode else S, h, D, generator=g)
    k = torch.randn(B, S, hk, D, generator=g)
    v = torch.randn(B, S, hk, D, generator=g)
    w = torch.randn(B, 1 if decode else S, h, D, generator=g)
    return q, k, v, w


def _attn(decode):
    if decode:
        valid = torch.arange(S) < S - 2
        return lambda q, k, v: L.decode_attention(
            q, k, v, valid[None].expand(q.shape[0], S))
    return lambda q, k, v: L.chunked_attention(q, k, v, causal=True,
                                               q_chunk=4, kv_chunk=4)


def _run(q, k, v, w, attn, mesh=None):
    from torch.distributed.tensor import DTensor, Replicate
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    args = leaves if mesh is None else [
        DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                           run_check=False) for t in leaves]
    o = T._local_heads(attn, *args)
    placements = None if mesh is None else tuple(o.placements)
    if mesh is not None:
        o = o.full_tensor()
    (o * w).sum().backward()
    return o.detach(), [t.grad for t in leaves], placements


def _rank(rank):
    from torch.distributed.device_mesh import init_device_mesh
    out = {}
    for name, (dp, mp, h, hk, _) in CASES.items():
        mesh = init_device_mesh("cpu", (dp, mp),
                                mesh_dim_names=("data", "model"))
        for decode in (False, True):
            out[(name, decode)] = _run(*_inputs(h, hk, decode),
                                       _attn(decode), mesh)
    return out


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(_rank, 4, timeout=240)


@pytest.mark.parametrize("decode", [False, True], ids=["chunked", "decode"])
@pytest.mark.parametrize("name", list(CASES))
def test_local_heads_over_ranks_hold_one_device(ranks, name, decode):
    from torch.distributed.tensor import Replicate, Shard
    *_, h, hk, split = CASES[name]
    want, want_grads, _ = _run(*_inputs(h, hk, decode), _attn(decode))
    for r in ranks:
        got, grads, placements = r[(name, decode)]
        assert placements[1] == (Shard(2) if split else Replicate())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        for g, wg in zip(grads, want_grads):
            torch.testing.assert_close(g, wg, rtol=1e-5, atol=1e-6)
