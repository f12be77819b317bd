"""The port's serving path (`models/transformer.py::prefill` /
`decode_step`, `models/api.py`, `launch/steps.py`, `launch/serve.py`,
`convert.model_cache_to_torch`) held against the JAX reference on the
CPU at every architecture's `smoke_config` (float32):

  * prefill's last-token logits and every cache buffer;
  * 4 decode steps from the reference's own prefill cache (converted);
  * greedy generation: the same tokens;
  * bf16 (smollm-135m, qwen3-moe-30b-a3b, mamba2-1.3b): the port's
    error against the f32 reference at most 2× the reference's own bf16
    error (the kernels/parity.py rule), forward, prefill and decode;
  * the port's own prefill + decode against its full forward, the SWA
    ring past the window, bounded decode state;
  * the input and cache specs against the reference's;
  * the serve CLI on the CPU (`--device cpu`), its seeded sampling, and
    that without `--device` it refuses to run where there is no card.

Tolerances as in test_torch_models.py (the float64 runs equal; 1e-4, or
the float64 rule).
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.models import api as JAPI
from repro.models import transformer as JT

from repro_torch import convert
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import serve, steps
from repro_torch.models import api as TAPI
from repro_torch.models import transformer as TT

from test_torch_models import (ARCHS, B, S, float64_port,
                               float64_reference, hold, jax_batch, models,
                               np64, np_batch, port64_cfg, torch_batch)

ROOT = Path(__file__).resolve().parent.parent
GEN = 4                     # decode steps held against the reference


def _steps_tokens(cfg, seed=9):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (GEN, B, 1)).astype(np.int32)


def _cache_leaves(cache):
    """[(layer, key, array)] of the port's per-layer cache."""
    return [(i, k, v) for i, e in enumerate(cache["layers"])
            for k, v in sorted(e.items())]


@functools.lru_cache(maxsize=None)
def _serve(arch: str):
    """Both packages' prefill, decode from the reference's cache, and
    greedy generation; both packages' prefill and decode also in
    float64, decode from the reference's float32 cache."""
    jcfg, tcfg, jp, tp, tp64 = models(arch)
    nb = np_batch(jcfg, B, S)
    toks = _steps_tokens(jcfg)
    max_len = S + GEN + 1
    j_prefill = jax.jit(lambda p, b: JT.prefill(p, b, jcfg, max_len=max_len))
    j_decode = jax.jit(lambda p, c, t: JT.decode_step(p, c, t, jcfg))
    jl, jcache = j_prefill(jp, jax_batch(nb))
    jcache_np = jax.tree.map(np.asarray, jcache)
    r = {"jl": np.asarray(jl), "jcache": jcache_np, "jdec": [],
         "jgreedy": [], "tdec": [], "t64dec": [], "tgreedy": []}
    c = jcache
    for t in toks:
        lg, c = j_decode(jp, c, jnp.asarray(t))
        r["jdec"].append(np.asarray(lg))
    tok, c = jnp.argmax(jl, -1)[:, None], jcache
    for _ in range(GEN):
        r["jgreedy"].append(np.asarray(tok))
        lg, c = j_decode(jp, c, tok.astype(jnp.int32))
        tok = jnp.argmax(lg, -1)[:, None]
    r["jgreedy"] = np.concatenate(r["jgreedy"], 1)

    with torch.no_grad():
        r["tl"], r["tcache"] = TT.prefill(tp, torch_batch(nb), tcfg,
                                          max_len=max_len)
        c = convert.model_cache_to_torch(jcache_np, tcfg, "cpu")
        for t in toks:
            lg, c = TT.decode_step(tp, c, torch.as_tensor(t).long(), tcfg)
            r["tdec"].append(lg)
        tok, c = r["tl"].argmax(-1)[:, None], r["tcache"]
        greedy = []
        for _ in range(GEN):
            greedy.append(tok)
            lg, c = TT.decode_step(tp, c, tok, tcfg)
            tok = lg.argmax(-1)[:, None]
        r["tgreedy"] = torch.cat(greedy, 1).numpy()
        with float64_port():
            c64 = port64_cfg(tcfg)
            r["t64l"], r["t64cache"] = TT.prefill(
                tp64, torch_batch(nb, torch.float64), c64, max_len=max_len)
            c = convert.model_cache_to_torch(
                jax.tree.map(lambda a: np.asarray(a, np.float64),
                             jcache_np), c64, "cpu")
            for t in toks:
                lg, c = TT.decode_step(tp64, c, torch.as_tensor(t).long(),
                                       c64)
                r["t64dec"].append(lg)
    with float64_reference():
        j64 = jcfg.replace(dtype="float64")
        jp64 = np64(jax.tree.map(np.asarray, jp))
        jl64, jcache64 = jax.jit(
            lambda p, b: JT.prefill(p, b, j64, max_len=max_len))(
            jp64, np64(nb))
        r["jl64"], r["jcache64"] = np64((jl64, jcache64))
        j_decode64 = jax.jit(lambda p, c, t: JT.decode_step(p, c, t, j64))
        c, r["jdec64"] = np64(jcache_np), []
        for t in toks:
            lg, c = j_decode64(jp64, c, t)
            r["jdec64"].append(np.asarray(lg))
    return r


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_reference(arch):
    r = _serve(arch)
    tcfg = models(arch)[1]
    assert r["tl"].shape == (B, tcfg.vocab_size)
    hold(r["tl"], r["jl"], r["jl64"], r["t64l"], f"{arch} prefill logits")
    assert r["tcache"]["index"] == int(r["jcache"]["index"]) == S
    period = TT.period_of(tcfg)
    got = _cache_leaves(r["tcache"])
    assert len(got) == sum(len(e) for e in r["jcache"]["layers"].values()) \
        * (tcfg.num_layers // period)
    for (i, k, v), (_, _, v64) in zip(got, _cache_leaves(r["t64cache"])):
        pos, rep = f"pos{i % period}", i // period
        want = r["jcache"]["layers"][pos][k][rep]
        assert tuple(v.shape) == want.shape and v.dtype == torch.float32
        hold(v, want, r["jcache64"]["layers"][pos][k][rep], v64,
             f"{arch} layer {i} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_from_reference_cache_match(arch):
    r = _serve(arch)
    for t, (got, want, j64, t64) in enumerate(zip(
            r["tdec"], r["jdec"], r["jdec64"], r["t64dec"])):
        hold(got, want, j64, t64, f"{arch} decode step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_reference(arch):
    r = _serve(arch)
    np.testing.assert_array_equal(r["tgreedy"], r["jgreedy"])


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-30b-a3b",
                                  "mamba2-1.3b"])
def test_bf16_error_within_twice_the_references(arch):
    """bf16 compute: max |port_bf16 − ref_f32| ≤ 2 × max |ref_bf16 −
    ref_f32|, on the forward logits, the prefill logits and GEN decode
    steps (each from its own prefill's cache, the same tokens)."""
    jcfg32, _, jp, _, _ = models(arch)
    jcfg, tcfg, _, tp, _ = models(arch, "bfloat16")
    nb = np_batch(jcfg, B, S)
    toks = _steps_tokens(jcfg)
    max_len = S + GEN

    def ref_decode(cfg):
        lg, c = JT.prefill(jp, jax_batch(nb), cfg, max_len=max_len)
        step = jax.jit(lambda c, t: JT.decode_step(jp, c, t, cfg))
        out = [lg]
        for t in toks:
            lg, c = step(c, jnp.asarray(t))
            out.append(lg)
        return jnp.stack(out, 1)

    with torch.no_grad():
        tfwd, _ = TT.forward(tp, torch_batch(nb), tcfg)
        tpre, c = TT.prefill(tp, torch_batch(nb), tcfg, max_len=max_len)
        tdec = [tpre]
        for t in toks:
            lg, c = TT.decode_step(tp, c, torch.as_tensor(t).long(), tcfg)
            tdec.append(lg)
    for name, port, ref32, ref16 in [
            ("forward", tfwd,
             JT.forward(jp, jax_batch(nb), jcfg32, remat="none")[0],
             JT.forward(jp, jax_batch(nb), jcfg, remat="none")[0]),
            ("prefill and decode", torch.stack(tdec, 1),
             ref_decode(jcfg32), ref_decode(jcfg))]:
        assert port.dtype == torch.float32       # f32 logits
        ref32 = np.asarray(ref32)
        port_err = float(np.abs(port.numpy() - ref32).max())
        ref_err = float(np.abs(np.asarray(ref16) - ref32).max())
        assert 0 < ref_err and port_err <= 2 * ref_err, (name, port_err,
                                                         ref_err)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_forward(arch):
    """The reference's own consistency check on the port (test_archs_
    smoke.py:53-68): prefill(S) and decode(token S) equal the forward over
    S + 1 tokens."""
    _, tcfg, _, tp, _ = models(arch)
    s = 32
    nb = torch_batch(np_batch(tcfg, B, s, seed=3))
    extra = torch.randint(0, tcfg.vocab_size, (B, 1),
                          generator=torch.Generator().manual_seed(7))
    full = dict(nb, tokens=torch.cat([nb["tokens"], extra], 1))
    with torch.no_grad():
        logits_full, _ = TT.forward(tp, full, tcfg)
        pre, cache = TT.prefill(tp, nb, tcfg, max_len=s + 4)
        dec, cache2 = TT.decode_step(tp, cache, extra, tcfg)
    torch.testing.assert_close(pre, logits_full[:, s - 1], atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(dec, logits_full[:, s], atol=1e-4, rtol=0)
    assert cache2["index"] == s + 1 and cache["index"] == s


def test_swa_ring_buffer_matches_full_attention():
    """h2o-danube at window 16: decoding past the window through the
    ring equals the windowed full forward."""
    _, tcfg, _, tp, _ = models("h2o-danube-3-4b")
    assert tcfg.sliding_window == 16
    s, gen = 24, 6
    toks = torch.randint(0, tcfg.vocab_size, (1, s + gen),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        full, _ = TT.forward(tp, {"tokens": toks}, tcfg)
        _, cache = TT.prefill(tp, {"tokens": toks[:, :s]}, tcfg,
                              max_len=s + gen)
        assert cache["layers"][0]["k"].shape[1] == 16
        for t in range(s, s + gen):
            lg, cache = TT.decode_step(tp, cache, toks[:, t:t + 1], tcfg)
            torch.testing.assert_close(lg, full[:, t], atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "h2o-danube-3-4b",
                                  "jamba-v0.1-52b"])
def test_decode_state_stays_bounded(arch):
    _, tcfg, _, tp, _ = models(arch)
    nb = torch_batch(np_batch(tcfg, B, 32))
    with torch.no_grad():
        _, cache = TT.prefill(tp, nb, tcfg, max_len=40)
        sizes = [{k: v.shape for k, v in e.items()} for e in cache["layers"]]
        tok = torch.zeros((B, 1), dtype=torch.long)
        for _ in range(4):
            _, cache = TT.decode_step(tp, cache, tok, tcfg)
    assert [{k: v.shape for k, v in e.items()}
            for e in cache["layers"]] == sizes


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_match_reference(arch):
    jcfg, tcfg = models(arch)[:2]
    for kind in ("train", "prefill", "decode"):
        jshape, tshape = JShape("c", kind, 16, 2), ShapeConfig("c", kind,
                                                               16, 2)
        jspecs, jaxes = JAPI.input_specs(jcfg, jshape)
        tspecs, taxes = TAPI.input_specs(tcfg, tshape)
        assert {k: v.shape for k, v in jspecs["batch"].items()} == {
            k: v[0] for k, v in tspecs["batch"].items()}
        assert jaxes["batch"] == taxes["batch"]
        batch = TAPI.synth_batch(torch.Generator().manual_seed(0), tcfg,
                                 tshape)
        assert {k: tuple(v.shape) for k, v in batch.items()} == {
            k: v[0] for k, v in tspecs["batch"].items()}
        if kind != "decode":
            continue
        period = TT.period_of(tcfg)
        for i, (e, a) in enumerate(zip(tspecs["cache"]["layers"],
                                       taxes["cache"]["layers"])):
            je = jspecs["cache"]["layers"][f"pos{i % period}"]
            ja = jaxes["cache"]["layers"][f"pos{i % period}"]
            assert {k: v[0] for k, v in e.items()} == {
                k: v.shape[1:] for k, v in je.items()}
            assert a == {k: v[1:] for k, v in ja.items()}
        zero = TT.cache_init(tcfg, 2, 16, 16 if tcfg.is_encdec else 0)
        assert zero["index"] == 0 and all(
            not v.any() for _, _, v in _cache_leaves(zero))


def test_step_builders_call_the_model():
    _, tcfg, _, tp, _ = models("smollm-135m")
    nb = torch_batch(np_batch(tcfg, B, S))
    with torch.no_grad():
        lg, cache = steps.make_prefill_step(tcfg, max_len=S + 2)(tp, nb)
        want, _ = TT.prefill(tp, nb, tcfg, max_len=S + 2)
        assert torch.equal(lg, want)
        tok = lg.argmax(-1)[:, None]
        lg2, cache2 = steps.make_decode_step(tcfg)(tp, cache,
                                                   {"tokens": tok})
        assert torch.equal(lg2, TT.decode_step(tp, cache, tok, tcfg)[0])
    assert cache2["index"] == S + 1


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-1.3b",
                                  "qwen3-moe-30b-a3b"])
def test_serve_main_decodes_the_argmax(arch, capsys):
    """serve.main on the CPU: the generated tokens are what a teacher-
    forced forward over prompt + generation picks at every position (the
    check chip_smoke makes at full width), and it prints the reference's
    lines."""
    out = serve.main(["--arch", arch, "--smoke", "--prompt-len", "16",
                      "--gen", "6", "--batch", "3", "--device", "cpu",
                      "--warmup", "1", "--layers", "2"])
    printed = capsys.readouterr().out
    assert "prefill 3×16 in" in printed and "tok/s" in printed
    assert "decode 5 steps" in printed
    assert out["tokens"].shape == (3, 6) and out["device"] == "cpu"
    assert out["cfg"].num_layers == 2 and len(out["params"]["blocks"]) == 2
    assert out["logits"].shape == (3, 6, out["cfg"].vocab_size)
    check = serve.teacher_forced(out)
    assert check["positions"] == 18 and check["mismatches"] == 0
    assert check["max_logit_diff"] < 1e-4


def test_serve_sampling_is_seeded():
    argv = ["--smoke", "--prompt-len", "8", "--gen", "6", "--batch", "2",
            "--device", "cpu", "--temperature", "1.0"]
    a = serve.main(argv + ["--seed", "1"])["tokens"]
    b = serve.main(argv + ["--seed", "1"])["tokens"]
    c = serve.main(argv + ["--seed", "2"])["tokens"]
    assert torch.equal(a, b) and not torch.equal(a, c)


def _run(*argv, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *argv], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_serve_cli_on_the_cpu():
    out = _run("-m", "repro_torch.launch.serve", "--arch", "smollm-135m",
               "--smoke", "--prompt-len", "32", "--gen", "8", "--batch", "2",
               "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "prefill 2×32" in out.stdout and "tok/s" in out.stdout
    assert "decode 7 steps" in out.stdout


def test_serve_without_device_refuses_a_machine_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the no-device "
                    "behaviour is checked where there is none")
    out = _run("-m", "repro_torch.launch.serve", "--smoke", "--gen", "2")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "prefill" not in out.stdout


def test_model_modules_import_no_jax():
    code = ("import sys\n"
            "import repro_torch.models, repro_torch.models.api\n"
            "import repro_torch.models.layers, repro_torch.models.moe\n"
            "import repro_torch.models.mamba, repro_torch.models.multimodal\n"
            "import repro_torch.models.transformer\n"
            "import repro_torch.launch.serve, repro_torch.launch.steps\n"
            "bad = [n for n in sys.modules\n"
            "       if n.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = _run("-c", code)
    assert out.returncode == 0, out.stdout + out.stderr
