"""The port's training forward and backward (`repro_torch/models/` with
gradients, remat) held against the reference's on the CPU.

`loss_fn`'s gradients for every architecture's smoke config (the
reference's parameters converted, one numpy batch) are held by
`test_torch_models.hold`: both packages in float64 agree within 1e-9 of
scale, the float32 runs within 1e-4 of the leaf's scale or by its 2.5×
RMS rule against the reference's float64 gradients. The gradients do
not depend on ``remat`` (none / block / full equal bit for bit), while
what the backward keeps shrinks from none to block to full; and
`_GradBf16` is the reference's custom_vjp. The other five
architectures' gradients are `test_torch_train_grads.py`'s.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JX
from repro.models import transformer as JT

from repro_torch import convert
from repro_torch.models import moe as TX
from repro_torch.models import transformer as TT
from repro_torch.optim.tree import leaves, stacked_leaves

from test_torch_models import (ARCHS, B, S, float64_port, float64_reference,
                               hold, jax_batch, models, np64, np_batch,
                               port64_cfg, torch_batch)


def port_grads(params, batch, cfg, remat="block"):
    """loss_fn's gradients in the reference's stacked layout (numpy)."""
    loss, _ = TT.loss_fn(params, batch, cfg, remat=remat)
    grads = torch.autograd.grad(loss, leaves(params), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves(params), grads)]
    return convert.stack_to_numpy(grads, stacked_leaves(params))


@functools.lru_cache(maxsize=None)
def _grads(arch: str):
    jcfg, tcfg, jp, tp, tp64 = models(arch)
    nb = np_batch(jcfg, B, S, labels=True)

    def jloss(p, b, c):
        return JT.loss_fn(p, b, c, remat="block")[0]

    jg = jax.tree.map(np.asarray, jax.jit(jax.grad(
        functools.partial(jloss, c=jcfg)))(jp, jax_batch(nb)))
    tg = port_grads(tp, torch_batch(nb), tcfg)
    with float64_port():
        tg64 = port_grads(tp64, torch_batch(nb, torch.float64),
                          port64_cfg(tcfg))
    with float64_reference():
        j64 = jcfg.replace(dtype="float64")
        jg64 = np64(jax.jit(jax.grad(functools.partial(jloss, c=j64)))(
            np64(jax.tree.map(np.asarray, jp)), np64(nb)))
    return jg, tg, jg64, tg64


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def hold_grads(arch):
    jg, tg, jg64, tg64 = _grads(arch)
    j, t, j64, t64 = _flat(jg), _flat(tg), _flat(jg64), _flat(tg64)
    assert sorted(j) == sorted(t) == sorted(j64) == sorted(t64)
    for k in j:
        hold(t[k], j[k], j64[k], t64[k], f"{arch}:{k}")


@pytest.mark.parametrize("arch", ARCHS[:5])
def test_loss_gradients_match_reference(arch):
    hold_grads(arch)


@pytest.mark.parametrize("arch", ["smollm-135m", "jamba-v0.1-52b",
                                  "seamless-m4t-large-v2"])
def test_gradients_do_not_depend_on_remat(arch):
    """none / block / full give the same bits; outside a repeat's
    checkpoint the backward keeps a tenth or less of what "none" keeps
    (saved bytes through saved_tensors_hooks)."""
    _, tcfg, _, tp, _ = models(arch)
    batch = torch_batch(np_batch(tcfg, B, S, labels=True))
    saved, grads = {}, {}
    for remat in ("none", "block", "full"):
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = TT.loss_fn(tp, batch, tcfg, remat=remat)
        saved[remat] = total[0]
        grads[remat] = torch.autograd.grad(loss, leaves(tp),
                                           allow_unused=True)
    for remat in ("block", "full"):
        for a, b in zip(grads["none"], grads[remat]):
            assert (a is None and b is None) or torch.equal(a, b), remat
    assert saved["full"] == saved["block"] < saved["none"] / 5, saved


def test_block_remat_saves_the_projections_only(monkeypatch):
    """"block" keeps the products without batch dimensions — q, k, v,
    o and the MLP's three, einsum's bmm over a batch of 1 — and
    recomputes the attention's batched products; "full" keeps none."""
    _, tcfg, _, tp, _ = models("smollm-135m")
    batch = torch_batch(np_batch(tcfg, B, S, labels=True))
    kept, recomputed = [], []
    policy = TT._saveable

    def spy(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if op == torch.ops.aten.bmm.default and not ctx.is_recompute:
            shape = (args[0].shape[0], args[0].shape[1], args[1].shape[2])
            (kept if out == TT.CheckpointPolicy.MUST_SAVE
             else recomputed).append(shape)
        return out

    monkeypatch.setattr(TT, "_saveable", spy)
    loss, _ = TT.loss_fn(tp, batch, tcfg, remat="block")
    d, f = tcfg.d_model, tcfg.d_ff
    hd, h, kv = tcfg.resolved_head_dim, tcfg.num_heads, tcfg.num_kv_heads
    layers = tcfg.num_layers
    want = ([(1, B * S, h * hd)] + [(1, B * S, kv * hd)] * 2
            + [(1, B * S, d)] + [(1, B * S, f)] * 2 + [(1, B * S, d)])
    assert sorted(kept) == sorted(want * layers), kept
    assert recomputed and all(s[0] > 1 for s in recomputed)
    torch.autograd.grad(loss, leaves(tp), allow_unused=True)
    kept.clear()
    TT.loss_fn(tp, batch, tcfg, remat="full")
    assert not kept


def test_grad_bf16_is_the_reference_custom_vjp():
    """On a bf16 primal (token_exchange's) the cotangent rounds to bf16,
    as the reference's `_grad_bf16` bwd casts it."""
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    g = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    _, vjp = jax.vjp(JX._grad_bf16, xb)
    want, = vjp(jnp.asarray(g, jnp.bfloat16))
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    y = TX._grad_bf16(tx)
    assert torch.equal(y, tx)
    got, = torch.autograd.grad(y, tx, torch.from_numpy(g).to(
        torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    # an f32 cotangent is rounded through bf16 too
    tf = torch.from_numpy(x).requires_grad_()
    got32, = torch.autograd.grad(TX._grad_bf16(tf), tf, torch.from_numpy(g))
    np.testing.assert_array_equal(
        got32.numpy(), torch.from_numpy(g).to(torch.bfloat16).float().numpy())
