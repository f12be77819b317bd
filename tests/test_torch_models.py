"""The port's model zoo (`repro_torch/models/`, `sharding/axes.py`'s
model part, `convert.model_params_to_torch`) held against the JAX
reference (`src/repro/models/`) on the CPU, at every architecture's
`smoke_config` (float32): the reference's parameters go through
`model_params_to_torch`, and the same numpy batch (one seed) through both
packages' `forward` and `loss_fn`.

Tolerance (`hold`): the port in float64 equals the reference in float64
(both packages' models computing in float64, the reference's under
jax's x64 mode) within 1e-9 of scale; and the float32 run max |port −
ref| ≤ 1e-4 · max(1, max |ref|), or the float64 rule: the port's RMS
error against the reference's float64 run at most 2.5× the reference's
own. The random-weight smoke models are ill-conditioned (a residual
stream that grows from 0.02 to ~50–90 in the first layer, SSM states in
the thousands), so both packages' float32 results sit up to ~1e-4 of
their scale from float64 (seamless' cache), where the port's RMS error
runs 1–2× the reference's (the per-op errors are equal).

Module-level checks: MoE routing against the reference's (equal keep
masks and slots, with a capacity that drops), MoE against its dense
oracle, chunked against decode attention over chunks and windows, the
SSD chunk scan against its decode recurrence, the enc-dec cross cache,
the llava patch overwrite, and the sharding rules and parameter axes.
"""
import contextlib
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import layers as JL
from repro.models import mamba as JM
from repro.models import moe as JX
from repro.models import transformer as JT
from repro.sharding import axes as JA

from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TM
from repro_torch.models import moe as TX
from repro_torch.models import transformer as TT
from repro_torch.sharding import axes as TA

ARCHS = sorted(JR.ARCHS)
ATOL = 1e-4
B, S = 2, 16


# ---------------------------------------------------------------------------
# shared helpers (test_torch_model_serve.py imports them)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def float64_reference():
    """The reference's models computing in float64 (jax's x64 mode, every
    module's F32): the yardstick, independent of the port, for both
    packages' float32 rounding error."""
    mods = (JL, JX, JM, JT)
    saved = [m.F32 for m in mods]
    with jax.enable_x64(True):
        for m in mods:
            m.F32 = jnp.float64
        try:
            yield
        finally:
            for m, f in zip(mods, saved):
                m.F32 = f


def np64(tree):
    """A numpy tree in 64 bits: floats float64, integers int64 (x64
    mode's default integer, which the reference's index arithmetic
    meets)."""
    return jax.tree.map(lambda a: np.asarray(
        a, np.float64 if np.issubdtype(np.asarray(a).dtype, np.floating)
        else np.int64), tree)


@contextlib.contextmanager
def float64_port():
    """The port's models computing in float64 (every module's F32): the
    yardstick for a float32 run's rounding error."""
    mods = (TL, TX, TM, TT)
    saved = [m.F32 for m in mods]
    for m in mods:
        m.F32 = torch.float64
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.F32 = f


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a))))


def hold(port, ref, ref64, port64, what: str, atol: float = ATOL) -> float:
    """The float64 runs equal (max |port64 − ref64| ≤ 1e-9 of ref64's
    scale); port ≈ ref within `atol` of ref's scale, or the port's RMS
    error against the reference's float64 run `ref64` within 2.5× the
    reference's own. Returns max |port − ref|."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    t, t_port = np.asarray(ref64, np.float64), np.asarray(port64, np.float64)
    assert port.shape == ref.shape == t.shape == t_port.shape, (
        what, port.shape, ref.shape, t.shape, t_port.shape)
    if not port.size:
        return 0.0
    err64 = float(np.abs(t_port - t).max())
    assert err64 <= 1e-9 * max(1.0, float(np.abs(t).max())), (what, err64)
    err = float(np.abs(port - ref).max())
    if err <= atol * max(1.0, float(np.abs(ref).max())):
        return err
    port_rms, ref_rms = _rms(port - t), _rms(ref - t)
    assert port_rms <= 2.5 * ref_rms, (what, err, port_rms, ref_rms)
    return err


def np_batch(cfg, b: int, s: int, seed: int = 0, labels: bool = False):
    """A numpy batch (tokens, labels, unit-norm frontend embeddings)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if labels:
        lab = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        lab[:, -1] = -1                       # a masked position
        out["labels"] = lab
    if cfg.frontend is not None:
        n = cfg.frontend.num_embeds or s
        f = rng.standard_normal((b, n, cfg.frontend.embed_dim)).astype(
            np.float32)
        out["frames" if cfg.is_encdec else "patches"] = (
            f / np.linalg.norm(f, axis=-1, keepdims=True))
    return out


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch, dtype=torch.float32):
    return {k: (torch.as_tensor(v).long() if v.dtype == np.int32
                else torch.as_tensor(v).to(dtype))
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def models(arch: str, dtype: str = "float32"):
    """(reference cfg, port cfg, reference params, port params, port
    params in float64) of an arch's smoke config; the reference's params
    in float64 (numpy) are `np64` of the third."""
    jcfg = JR.smoke_config(arch).replace(dtype=dtype)
    tcfg = TR.smoke_config(arch).replace(dtype=dtype)
    jp, _ = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.model_params_to_torch(jax.tree.map(np.asarray, jp), tcfg,
                                       "cpu")
    return jcfg, tcfg, jp, tp, convert.model_params_to_torch(
        jax.tree.map(lambda a: np.asarray(a, np.float64), jp), tcfg, "cpu")


def port64_cfg(tcfg):
    return tcfg.replace(dtype="float64")


@functools.lru_cache(maxsize=None)
def _forwards(arch: str):
    jcfg, tcfg, jp, tp, tp64 = models(arch)
    nb = np_batch(jcfg, B, S, labels=True)
    jl, jaux = jax.jit(lambda p, b: JT.forward(p, b, jcfg, remat="none"))(
        jp, jax_batch(nb))
    jloss, jmet = jax.jit(lambda p, b: JT.loss_fn(p, b, jcfg,
                                                  remat="none"))(
        jp, jax_batch(nb))
    with torch.no_grad():
        tl, taux = TT.forward(tp, torch_batch(nb), tcfg)
        tloss, tmet = TT.loss_fn(tp, torch_batch(nb), tcfg)
        with float64_port():
            c64 = port64_cfg(tcfg)
            b64 = torch_batch(nb, torch.float64)
            t64, taux64 = TT.forward(tp64, b64, c64)
            loss64, met64 = TT.loss_fn(tp64, b64, c64)
    with float64_reference():
        j64 = jcfg.replace(dtype="float64")
        jp64, nb64 = np64(jax.tree.map(np.asarray, jp)), np64(nb)
        jl64, jaux64 = jax.jit(lambda p, b: JT.forward(p, b, j64,
                                                       remat="none"))(
            jp64, nb64)
        jloss64, jmet64 = jax.jit(lambda p, b: JT.loss_fn(p, b, j64,
                                                          remat="none"))(
            jp64, nb64)
        jl64, jaux64, jloss64, jmet64 = np64((jl64, jaux64, jloss64, jmet64))
    return dict(jl=np.asarray(jl), jaux=jaux, tl=tl, taux=taux, t64=t64,
                taux64=taux64, jl64=jl64, jaux64=jaux64,
                jloss=float(jloss), jmet=jmet, tloss=float(tloss),
                tmet=tmet, loss64=float(loss64), met64=met64,
                jloss64=float(jloss64), jmet64=jmet64)


# ---------------------------------------------------------------------------
# every architecture
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    r = _forwards(arch)
    cfg = models(arch)[1]
    assert r["tl"].shape == (B, S, cfg.vocab_size)
    assert r["tl"].dtype == torch.float32
    hold(r["tl"], r["jl"], r["jl64"], r["t64"], f"{arch} logits")
    assert sorted(r["taux"]) == sorted(r["jaux"])
    for k in r["jaux"]:
        hold(r["taux"][k], r["jaux"][k], r["jaux64"][k], r["taux64"][k],
             f"{arch} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch):
    r = _forwards(arch)
    hold(r["tloss"], r["jloss"], r["jloss64"], r["loss64"], f"{arch} loss")
    assert sorted(r["tmet"]) == sorted(r["jmet"])
    for k in r["jmet"]:
        hold(r["tmet"][k], r["jmet"][k], r["jmet64"][k], r["met64"][k],
             f"{arch} {k}")


def _leaves(tree):
    """{name: shape} of a Params tree's parameters."""
    return {k: tuple(v.shape) for k, v in tree.named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_mirror_reference_layout(arch):
    """The port's own init: the converted reference tree's names and
    shapes, f32 parameters, logical axes naming every parameter as the
    reference's (blocks/pos{i} → blocks/{layer}), and as many
    parameters."""
    jcfg, tcfg, jp, tp, _ = models(arch)
    mine, axes = TT.init_params(torch.Generator().manual_seed(0), tcfg)
    assert _leaves(mine) == _leaves(tp)
    assert all(p.dtype == torch.float32 for p in mine.parameters())
    # as many as the reference's tree (cfg.param_count() also counts a
    # Mamba conv bias that neither package's init makes)
    assert sum(p.numel() for p in mine.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    _, jaxes = JT.init_params(None, jcfg, abstract=True)
    period = JT.period_of(jcfg)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            out.update(flat(v, path) if isinstance(v, dict) else {path: v})
        return out

    want = {}
    for path, ax in flat(jaxes).items():
        parts = path.split("/")
        if parts[0] == "blocks" or parts[:2] == ["encoder", "blocks"]:
            at = parts.index("blocks") + 1
            pos = int(parts[at][3:])
            n = (tcfg.encoder_layers if parts[0] == "encoder"
                 else tcfg.num_layers // period)
            stride = 1 if parts[0] == "encoder" else period
            for r in range(n):
                q = parts[:at] + [str(r * stride + pos)] + parts[at + 1:]
                want["/".join(q)] = ax[1:]          # the stacked dim off
        else:
            want[path] = ax
    assert flat(axes) == want


# ---------------------------------------------------------------------------
# module level
# ---------------------------------------------------------------------------


def _moe_params(cfg, seed=0):
    b = JA.ParamBuilder(jax.random.PRNGKey(seed))
    jp = JX.moe_init(b, "moe", cfg, cfg.moe)
    tp = convert._params_node(jax.tree.map(np.asarray, jp),
                              torch.device("cpu"))
    return jp, tp


def _reference_routing(jp, x, mcfg, group: int):
    """The reference's routing lines (moe.py:96-110) → slot, keep."""
    tokens = x.shape[0] * x.shape[1]
    xg = jnp.asarray(x).reshape(tokens // group, group, -1)
    logits = jnp.einsum("gte,ex->gtx", xg.astype(jnp.float32),
                        jp["router"], preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, mcfg.top_k)
    onehot = jax.nn.one_hot(idx, mcfg.num_experts, dtype=jnp.float32)
    flat = onehot.reshape(xg.shape[0], group * mcfg.top_k, -1)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
    cap = JX._capacity(group, mcfg)
    keep = jnp.any((pos < cap) & (onehot > 0), axis=-1)
    slot = jnp.sum(pos * onehot, axis=-1)
    return np.asarray(idx), np.asarray(slot).astype(np.int64), \
        np.asarray(keep)


@pytest.mark.parametrize("capacity_factor,group", [(0.5, 32), (4.0, 64),
                                                   (1.0, 24)])
def test_moe_apply_matches_reference_with_drops(capacity_factor, group):
    """Routing decisions (experts, slots, keep) equal the reference's,
    output and aux within tolerance — with a capacity that drops, one
    without drops, and a group that pads the token count."""
    jcfg, tcfg = (c.replace(moe=dataclasses.replace(
        c.moe, capacity_factor=capacity_factor))
        for c in (JR.smoke_config("qwen3-moe-30b-a3b"),
                  TR.smoke_config("qwen3-moe-30b-a3b")))
    jp, tp = _moe_params(jcfg)
    x = np.random.default_rng(1).standard_normal(
        (2, 32, jcfg.d_model)).astype(np.float32)
    jy, jaux = JX.moe_apply(jp, jnp.asarray(x), jcfg, jcfg.moe,
                            group_size=group)
    with torch.no_grad():
        ty, taux = TX.moe_apply(tp, torch.tensor(x), tcfg, tcfg.moe,
                                group_size=group)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=0)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   atol=1e-5, rtol=1e-6)
    tokens = x.shape[0] * x.shape[1]
    if tokens % group == 0:
        idx, slot, keep = _reference_routing(jp, x, jcfg.moe, group)
        xg = torch.tensor(x).reshape(tokens // group, group, -1)
        _, _, _, _, tidx, tslot, tkeep = TX._route(
            tp, xg, tcfg.moe, TX._capacity(group, tcfg.moe))
        np.testing.assert_array_equal(tidx.numpy(), idx)
        np.testing.assert_array_equal(tkeep.numpy(), keep)
        np.testing.assert_array_equal(tslot.numpy()[keep], slot[keep])
    if capacity_factor < 1:
        assert float(taux["moe_drop_fraction"]) > 0


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_apply_equals_dense_oracle_without_drops(arch):
    cfg = TR.smoke_config(arch)
    jp, tp = _moe_params(JR.smoke_config(arch))
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(2))
    with torch.no_grad():
        y, aux = TX.moe_apply(tp, x, cfg, cfg.moe)
        want = TX.moe_dense_reference(tp, x, cfg, cfg.moe)
        jwant = JX.moe_dense_reference(jp, jnp.asarray(x.numpy()),
                                       JR.smoke_config(arch),
                                       JR.smoke_config(arch).moe)
    assert float(aux["moe_drop_fraction"]) == 0.0
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant), atol=1e-5,
                               rtol=1e-5)


def test_grad_bf16_rounds_the_cotangent_to_bf16():
    """Identity forward; the cotangent passes through bf16 (1 + 2^-12
    rounds to 1; autograd hands it back in the primal's dtype)."""
    x = torch.ones(3, dtype=torch.float32, requires_grad=True)
    y = TX._grad_bf16(x)
    assert torch.equal(y, x)
    g = torch.autograd.grad(y, x, torch.full((3,), 1.0 + 2 ** -12))[0]
    assert torch.equal(g, torch.ones(3))


@pytest.mark.parametrize("window,chunk", [(0, 8), (0, 32), (5, 8),
                                          (16, 16)])
def test_chunked_attention_equals_decode_attention(window, chunk):
    """Row t of the chunked (causal, optionally windowed) attention
    equals decode attention of query t over keys ≤ t in the window; and
    both equal the reference's."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn((2, 32, 4, 16), generator=g)
    k = torch.randn((2, 32, 2, 16), generator=g)
    v = torch.randn((2, 32, 2, 16), generator=g)
    out = TL.chunked_attention(q, k, v, causal=True, window=window,
                               q_chunk=chunk, kv_chunk=chunk)
    ref = JL.chunked_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                               causal=True, window=window, q_chunk=chunk,
                               kv_chunk=chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
    pos = torch.arange(32)
    for t in range(32):
        valid = (pos <= t) & ((pos > t - window) if window else True)
        dec = TL.decode_attention(q[:, t:t + 1], k, v,
                                  valid[None].expand(2, 32))
        torch.testing.assert_close(dec[:, 0], out[:, t], atol=1e-6,
                                   rtol=1e-6)


def test_mamba_chunk_scan_equals_decode_recurrence():
    """The chunked SSD forward over S tokens equals S exact decode steps
    from an empty cache, output by output, and its final state the last
    step's; the chunked forward equals the reference's."""
    cfg = TR.smoke_config("mamba2-1.3b")         # chunk 8
    jcfg = JR.smoke_config("mamba2-1.3b")
    jp = JM.mamba_init(JA.ParamBuilder(jax.random.PRNGKey(4)), "m", jcfg)
    tp = convert._params_node(jax.tree.map(np.asarray, jp),
                              torch.device("cpu"))
    u = torch.randn((2, 21, cfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        y, st = TM.mamba_apply_with_state(tp, u, cfg)
        cache = TM.mamba_cache_init(cfg, 2, torch.float32)
        steps = []
        for t in range(u.shape[1]):
            yt, cache = TM.mamba_decode_step(tp, cache, u[:, t:t + 1], cfg)
            steps.append(yt)
    torch.testing.assert_close(torch.cat(steps, 1), y, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(cache["state"], st["state"], atol=1e-5,
                               rtol=1e-4)
    for key in ("conv_x", "conv_B", "conv_C"):
        torch.testing.assert_close(cache[key], st[key], atol=1e-6,
                                   rtol=1e-6)
    jy, jst = JM.mamba_apply_with_state(jp, jnp.asarray(u.numpy()), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(st["state"].numpy(), np.asarray(jst["state"]),
                               atol=1e-5, rtol=0)


def test_seamless_cross_attention_cache():
    """The enc-dec prefill caches every decoder layer's cross K/V over
    the encoder memory, the reference's within tolerance, and decode
    carries them unchanged."""
    arch = "seamless-m4t-large-v2"
    jcfg, tcfg, jp, tp, _ = models(arch)
    nb = np_batch(jcfg, B, S)
    _, jcache = JT.prefill(jp, jax_batch(nb), jcfg, max_len=S + 2)
    with torch.no_grad():
        _, cache = TT.prefill(tp, torch_batch(nb), tcfg, max_len=S + 2)
        _, cache2 = TT.decode_step(tp, cache, torch.zeros((B, 1),
                                                          dtype=torch.long),
                                   tcfg)
    for i, e in enumerate(cache["layers"]):
        for key in ("ck", "cv"):
            assert e[key].shape == (B, S, tcfg.num_kv_heads,
                                    tcfg.resolved_head_dim)
            want = np.asarray(jcache["layers"]["pos0"][key][i])
            np.testing.assert_allclose(e[key].numpy(), want, atol=1e-4,
                                       rtol=1e-5)
            assert cache2["layers"][i][key] is e[key]


def test_llava_patches_overwrite_the_first_positions():
    arch = "llava-next-mistral-7b"
    _, tcfg, _, tp, _ = models(arch)
    nb = torch_batch(np_batch(tcfg, B, S))
    npatch = nb["patches"].shape[1]
    assert 0 < npatch < S
    x = TT._embed_inputs(tp, nb, tcfg, None)
    proj = TT._project_frontend(tp, nb["patches"], torch.float32)
    torch.testing.assert_close(x[:, :npatch], proj, atol=0, rtol=0)
    tok = TL.embed_tokens(tp["embed"], nb["tokens"], tcfg)
    torch.testing.assert_close(x[:, npatch:], tok[:, npatch:], atol=0,
                               rtol=0)


def test_sharding_rules_and_profiles_equal_reference():
    assert TA.DEFAULT_PARAM_RULES == JA.DEFAULT_PARAM_RULES
    assert TA.DEFAULT_ACT_RULES == JA.DEFAULT_ACT_RULES
    assert TA.DP_ONLY_PARAM_RULES == JA.DP_ONLY_PARAM_RULES
    assert TA.DP_ONLY_ACT_RULES == JA.DP_ONLY_ACT_RULES
    assert TA.current_profile() == "default"
    try:
        TA.use_profile("dp_only")
        assert TA.current_param_rules() == TA.DP_ONLY_PARAM_RULES
        assert TA.current_act_rules() == TA.DP_ONLY_ACT_RULES
    finally:
        TA.use_profile("default")
    assert TA.current_act_rules() == JA.DEFAULT_ACT_RULES
    with pytest.raises(KeyError):
        TA.use_profile("nope")
    x = torch.ones(2, 3)
    assert TA.constrain(x, None, "act_batch", None) is x
    assert TA.constrain(x, {"data": 1, "model": 1}, "act_batch", None) is x
    # past one device a plain tensor has left the sharded path
    with pytest.raises(TypeError, match="sharded path"):
        TA.constrain(x, {"data": 2}, "act_batch", None)
    flat = {"a/b/c": ("embed",), "a/d": (None,)}
    assert TA.unflatten_axes(flat) == JA.unflatten_axes(flat)


def test_param_builder_draws_from_its_generator():
    def build(seed):
        b = TA.ParamBuilder(torch.Generator().manual_seed(seed))
        return (b.param("w", (64, 32), ("embed", "mlp")),
                b.param("u", (8,), (None,), init="uniform", scale=0.5),
                b.param("z", (4,), (None,), init="zeros"), b.axes)
    w, u, z, axes = build(0)
    assert torch.equal(w, build(0)[0]) and not torch.equal(w, build(1)[0])
    assert abs(float(w.std()) - 1 / math.sqrt(64)) < 0.02
    assert float(u.abs().max()) <= 0.5 and not bool(z.any())
    assert axes == {"w": ("embed", "mlp"), "u": (None,), "z": (None,)}
    b = TA.ParamBuilder(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        b.param("w", (3,), ("embed", "mlp"))
    with pytest.raises(ValueError):
        b.param("w", (3,), ("embed",), init="glorot")
