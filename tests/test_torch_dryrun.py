"""The compile-and-cost launchers (`launch/dryrun.py`, `hillclimb.py`,
`reprobe.py`) held against the reference's.

The reference's `dryrun` and `hillclimb` append 512 host devices to
XLA_FLAGS when imported, so they run in two JAX subprocesses (started
with the module, in the background), on the production meshes rebuilt
with Auto axes (ROADMAP §C F1: its own Explicit-axis mesh refuses its
constrain). Their numbers come back as JSON.

Exact: the cell grid and the technique cells, every arch's optimizer,
codec, remat and shrunk depths, every train cell's microbatches on both
meshes, the fits, the collectives' moved bytes, the roofline terms
under one HW, and the arguments a device of the five smoke cells (ids
and tokens int64 in the port, int32 in the reference; a decode cache's
index a host int in the port, an int32 scalar in the reference). As a
ratio: flops a device (ROADMAP §C D4 for the ways of counting) of the
smoke cells and of the same cells with a batch and query heads that the
mesh divides (§C W1, W2). The port against itself: the probe fit against a direct 3× trace, the live-bytes
peak of a real CPU step against the meta step's, per-device products,
the technique cell on a fake world against rank 0 of real gloo ranks,
the quadratic fit in k against direct counts, and the three CLIs.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile

import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.configs.base import OptimConfig, ShapeConfig, TrainConfig
from repro_torch.kernels import counters
from repro_torch.launch import dryrun as DR
from repro_torch.launch import hillclimb as HC
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import reprobe as RP
from repro_torch.launch import steps
from repro_torch.launch.spawn import run_ranks
from repro_torch.models import api

ARCH = "qwen2.5-3b"
LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
# the technique cells cut to the reference's compile time (n 4,096, k 8;
# facility at d 16, kcover over a universe of 1,024)
TECH_CUT = {"greedyml-facility": dict(objective="facility", n=4096, d=16,
                                      k=8),
            "greedyml-kcover": dict(objective="kcover", n=4096,
                                    universe=1024, k=8)}
CELLS = LM_SHAPES + tuple(TECH_CUT)
# the ways of counting (eager ops against XLA's HloCostAnalysis: products
# alike, elementwise ops without fusion, transcendentals apart in both)
BAND = (0.5, 2.0)
# ROADMAP §C W2: the smoke LM cells over the 256-rank mesh. The port's
# sharded step gathers each FSDP weight at use and runs a batch of 4
# (which does not divide the 16 data ranks) whole on every data rank, its
# 4 heads (which do not divide 16) whole on every model rank, where
# XLA's partitioner splits the contracted embed dim into partial sums:
# the products (aten.bmm of the projections and attention) run 2.6–20×
# the reference's flops a device. At world 1 the two counts agree.
REPLICATED_ON_THE_MESH = LM_SHAPES
# The same cells with a batch and query heads that the mesh divides
# (16 rows over 16 data ranks, 16 query heads over 16 model ranks) and
# qwen2.5-3b's 2 key heads, which do not, at 2 layers: each rank's
# share, held in the band.
SPLIT = "qwen2.5-3b-split"
SPLIT_CFG = {"num_heads": 16, "num_kv_heads": 2, "num_layers": 2}
SPLIT_BATCH = 16
SPLIT_CELLS = tuple(f"{SPLIT}:{s}" for s in LM_SHAPES)

LIN_PTS = [(1, 3.0, 10.0, 7.5, 1.0), (2, 5.5, 14.0, 9.0, 2.0)]
QUAD_PTS = [(4, 318128.0, 10016.0, 204227.0), (8, 1235252.0, 20000.0,
                                               675807.0),
            (16, 4894556.0, 39968.0, 2442183.0)]
COLL_RECORDS = [("all-gather", 4096.0, 16), ("all-reduce", 256.0, 16),
                ("reduce-scatter", 1024.0, 256), ("all-to-all", 64.0, 16),
                ("collective-permute", 32.0, 2), ("all-reduce", 8.0, 1)]
TERMS_REC = {"per_device": {"memory": {"total_bytes": 3 * 2 ** 30}},
             "estimated": {"flops": 4.2e14, "bytes_accessed": 7.1e11,
                           "collective_moved_bytes": 2.5e9}}

REF_SCRIPT = r'''
import json, sys
inp = json.loads(sys.argv[1])
from repro.launch import dryrun as D, hillclimb as H   # 512 host devices
import jax, numpy as np
from repro.configs import registry as R
from repro.configs.base import TrainConfig
from repro.launch import steps as S
from repro.launch.mesh import make_production_mesh
from repro.runtime import flags as FL

def auto(multi):
    m = make_production_mesh(multi_pod=multi)
    return jax.sharding.Mesh(m.devices, m.axis_names)

mesh = auto(False)
if inp["part"] == "split":
    # the split-heads cells, in a second process beside the first
    import dataclasses
    base = R.smoke_config(inp["arch"])
    R.get_arch = {inp["split"]: dataclasses.replace(
        base, **inp["split_cfg"])}.__getitem__
    R.get_shape = {s: dataclasses.replace(R.smoke_shape(s),
                                          global_batch=inp["split_batch"])
                   for s in inp["shapes"]}.__getitem__
    res = {}
    for s in inp["shapes"]:
        with mesh:
            est = D.probe_lm_cell(inp["split"], s, mesh, 256)
        res[f"{inp['split']}:{s}"] = {"flops": est["flops"]}
    with open(inp["out"], "w") as f:
        json.dump({"cells_res": res}, f)
    sys.exit(0)

out = {"cells": [list(c) for c in R.cells(include_skipped=True)],
       "technique": {k: dict(v) for k, v in D.TECHNIQUE_CELLS.items()}}
out["cfgs"] = {}
for a in R.ARCHS:
    cfg, ocfg = D._cell_cfgs(a)
    out["cfgs"][a] = {
        "opt": ocfg.name, "compress": ocfg.compress_grads,
        "params": cfg.param_count(), "param_dtype": cfg.param_dtype,
        "remat": "full" if cfg.param_count() > 2e10 else "block",
        "shrink": [[D._shrink(cfg, r).num_layers,
                    D._shrink(cfg, r).encoder_layers] for r in (1, 2)],
        "opt_flops": [D._opt_flops_per_device(cfg, d) for d in (256, 512)]}
meshes = {"single": mesh, "multi": auto(True)}
out["n_micro"] = {f"{a}:{s}:{k}": S.num_microbatches(R.get_shape(s), m,
                                                     TrainConfig())
                  for a, s, skip in R.cells() if skip is None
                  and R.get_shape(s).kind == "train"
                  for k, m in meshes.items()}
out["lin"] = D._linfit(inp["lin_pts"], 7)
out["quad"] = D._quadfit(inp["quad_pts"], 256)
lines = [f"  %c{i} = f32[{int(b) // 4}]{{0}} {kind}(f32[1]{{0}} %p), "
         f"replica_groups=[{max(1, 256 // g)},{g}]<=[256]"
         for i, (kind, b, g) in enumerate(inp["records"])]
out["colls"] = D.parse_collectives("\n".join(lines))
H.HW.update(inp["hw"])
out["terms"] = H.terms(inp["rec"])

smoke = {inp["arch"]: R.smoke_config(inp["arch"])}
shapes = {s: R.smoke_shape(s) for s in inp["shapes"]}
R.get_arch = smoke.__getitem__
R.get_shape = shapes.__getitem__
one = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                        ("data", "model"))
res = {}
for s in shapes:
    cfg, ocfg = D._cell_cfgs(inp["arch"])
    with mesh:
        rec = D.analyze(D.lower_cell(cfg, ocfg, shapes[s], mesh).compile(),
                        256)
        est = D.probe_lm_cell(inp["arch"], s, mesh, 256)
    with one:
        est1 = D.probe_lm_cell(inp["arch"], s, one, 1)
    res[s] = {"memory": rec["per_device"]["memory"], "flops": est["flops"],
              "flops_world1": est1["flops"]}
D.TECHNIQUE_CELLS.update(inp["technique"])
scan = jax.lax.scan
def unrolled(*a, **kw):
    # the probes' stated intent: every scan unrolled (kernels/ref.py's
    # greedy loop passes no unroll=, so XLA counts its body once)
    if FL.UNROLL_SCANS:
        kw["unroll"] = True
    return scan(*a, **kw)
for name in inp["technique"]:
    with mesh:
        rec = D.analyze(D.lower_technique(name, mesh).compile(), 256)
        est = D.probe_technique_cell(name, mesh)
        jax.lax.scan = unrolled
        try:
            est_u = D.probe_technique_cell(name, mesh)
        finally:
            jax.lax.scan = scan
    res[name] = {"memory": rec["per_device"]["memory"], "flops": est["flops"],
                 "flops_unrolled": est_u["flops"]}
out["cells_res"] = res
with open(inp["out"], "w") as f:
    json.dump(out, f, default=str)
'''


class _Reference:
    """The reference's numbers, from two JAX subprocesses started with
    the module (the port's own tests run first, beside them): the split-
    heads cells in one, everything else in the other."""

    PARTS = ("main", "split")

    def __init__(self):
        self.dir = tempfile.TemporaryDirectory()
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        src = os.path.join(os.path.dirname(__file__), "..", "src")
        env["PYTHONPATH"] = os.pathsep.join(
            [src] + [p for p in [env.get("PYTHONPATH")] if p])
        self.procs = {}
        for part in self.PARTS:
            inp = {"part": part, "lin_pts": LIN_PTS, "quad_pts": QUAD_PTS,
                   "records": COLL_RECORDS, "hw": HC.HW, "rec": TERMS_REC,
                   "arch": ARCH, "shapes": LM_SHAPES, "technique": TECH_CUT,
                   "split": SPLIT, "split_cfg": SPLIT_CFG,
                   "split_batch": SPLIT_BATCH,
                   "out": os.path.join(self.dir.name, f"{part}.json")}
            self.procs[part] = subprocess.Popen(
                [sys.executable, "-c", REF_SCRIPT, json.dumps(inp)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._data = None

    def data(self):
        if self._data is None:
            parts = {}
            for part, proc in self.procs.items():
                _, err = proc.communicate(timeout=240)
                assert proc.returncode == 0, err[-3000:]
                with open(os.path.join(self.dir.name, f"{part}.json")) as f:
                    parts[part] = json.load(f)
            self._data = parts["main"]
            self._data["cells_res"].update(parts["split"]["cells_res"])
        return self._data

    def kill(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.fixture(scope="module", autouse=True)
def ref():
    r = _Reference()
    yield r
    r.kill()
    r.dir.cleanup()


def _smoke(shape_name):
    return (TR.smoke_config(ARCH).replace(param_dtype="bfloat16"),
            TR.smoke_shape(shape_name))


def _port_cell(shape_name, mesh_kind="single"):
    """(record of the smoke cell over `mesh_kind`, int64 ids' bytes a
    rank beyond int32)."""
    cfg, shape = _smoke(shape_name)
    ocfg = OptimConfig()
    if mesh_kind == "world1":
        mesh = TMESH.make_local_mesh(1, 1, device="cpu")
        return DR.lm_record(cfg, ocfg, shape, mesh, 1, DR._remat(cfg)), 0
    with DR.fake_world(256):
        mesh = DR.production_mesh("single")
        rec = DR.lm_record(cfg, ocfg, shape, mesh, 256, DR._remat(cfg))
        specs = api.input_specs(cfg, shape)[0]
        placed = DR._place_group(specs, steps.batch_shardings(cfg, shape,
                                                              mesh)[1])
        wide = sum(DR._local(t).numel() * 4
                   for t in DR._tensors(placed["batch"])
                   if t.dtype == torch.int64)
    return rec, wide


_PORT = {}


def port_cell(shape_name, mesh_kind="single"):
    key = (shape_name, mesh_kind)
    if key not in _PORT:
        _PORT[key] = _port_cell(shape_name, mesh_kind)
    return _PORT[key]


def port_split_cell(shape_name):
    """The port's flops a device of `SPLIT`'s cell over the single mesh."""
    key = (SPLIT, shape_name)
    if key not in _PORT:
        cfg, shape = _smoke(shape_name)
        cfg = cfg.replace(**SPLIT_CFG)
        shape = dataclasses.replace(shape, global_batch=SPLIT_BATCH)
        with DR.fake_world(256):
            mesh = DR.production_mesh("single")
            _PORT[key] = DR.probe_lm(cfg, OptimConfig(), shape, mesh, 256,
                                     DR._remat(cfg))["flops"]
    return _PORT[key]


_TECH = {}


def port_technique(name):
    if name not in _TECH:
        with DR.fake_world(256):
            _TECH[name] = DR.run_technique(name, "single", "cpu",
                                           spec=TECH_CUT[name])
    return _TECH[name]


# ---------------------------------------------------------------------------
# The port against itself
# ---------------------------------------------------------------------------


def _declared(fn):
    counters.reset()
    fn()
    c = {n: v for n, v in counters.costs().items() if v["cost"]}
    calls = {n: v["calls"] for n, v in counters.snapshot().items()
             if v["calls"]}
    counters.reset()
    assert {n: v["cost"] for n, v in c.items()} == calls
    return {n: (v["flops"], v["bytes"]) for n, v in c.items()}


def test_kernel_wrappers_declare_the_bound_columns_work():
    """Each wrapper's declared cost, on the CPU path, by PERF.md §6's
    bound rule: operations from the shapes, inputs read once, outputs
    written once (B = 2 greedies, N = 5 rows, C = 4 columns, D = 3)."""
    from repro_torch.kernels import fused_step as F
    from repro_torch.kernels import greedy_loop as L
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import rules as R
    g = torch.Generator().manual_seed(0)
    b, n, c, d, k = 2, 5, 4, 3, 3
    ground = torch.randn(b, n, d, generator=g)
    cands = torch.randn(b, c, d, generator=g)
    assert _declared(lambda: P.pairwise(ground, cands, "dist")) == {
        "pairwise": (2 * b * n * c * d + 2 * b * (n + c) * d + 4 * b * n * c,
                     4 * (b * n * d + b * c * d) + 4 * b * n * c)}
    rule = R.DIST_MIN
    row = R.empty_row(ground, torch.ones(b, n, dtype=torch.bool), rule)
    mask = torch.ones(b, c)
    cv = torch.ones(b, c, dtype=torch.bool)
    assert _declared(lambda: P.gains(ground, row, cands, cv, rule)) == {
        "gains": (2 * b * n * c * d + 4 * b * n * c + 2 * b * c * d,
                  4 * (b * n * d + b * n + b * c * d) + b * c + 4 * b * c
                  + 4 * b * n)}
    mat = P.pairwise(ground, cands, "dist")
    prev = torch.zeros(b, dtype=torch.int64)
    operands = 4 * (b * n * c + b * n + b * c)
    assert _declared(lambda: F.fused_step(mat, row, mask, prev, rule)) == {
        "fused_step": (3 * b * n * c, operands + 4 * b * n + 20 * b)}
    assert _declared(lambda: L.greedy_loop(mat, row, mask, k, rule)) == {
        "greedy_loop": (3 * k * b * n * c, operands + 4 * b * n + 8 * k * b)}
    ctl = torch.tensor([[k, n, c]] * b, dtype=torch.int32)
    rcands = torch.randn(b, n, d, generator=g)
    rmask = torch.ones(b, n)
    assert _declared(lambda: L.greedy_loop_resident(
        ground, rcands, row, rmask, ctl, k, rule)) == {
        "greedy_loop_resident": (
            2 * b * n * n * d + 2 * b * 2 * n * d + 4 * b * n * n
            + 3 * k * b * n * n,
            4 * (2 * b * n * d + b * n + b * n) + 4 * 3 * b + 4 * b * n
            + 8 * k * b)}
    w = 2
    words = torch.randint(0, 2 ** 31 - 1, (b, c, w), generator=g,
                          dtype=torch.int32)
    wrow = torch.zeros(b, w, dtype=torch.int32)
    assert _declared(lambda: L.greedy_loop(words.mT, wrow, mask, k,
                                           R.BITS_OR)) == {
        "greedy_loop[coverage]": (3 * k * b * c * w,
                                  4 * (b * c * w + b * w + b * c)
                                  + 4 * b * w + 8 * k * b)}


def test_probe_fit_equals_a_direct_3x_trace():
    cfg, shape = _smoke("train_4k")
    ocfg = OptimConfig()
    with DR.fake_world(256):
        mesh = DR.production_mesh("single")
        micro, _ = DR.micro_shape(shape, mesh, TrainConfig())
        pts = [DR._point(r, DR.trace_cell(DR._shrink(cfg, r), ocfg, micro,
                                          mesh, "block")) for r in (1, 2)]
        direct = DR._point(3, DR.trace_cell(DR._shrink(cfg, 3), ocfg, micro,
                                            mesh, "block"))
    # flops, collective bytes, bytes accessed, dot flops, temp bytes
    assert DR._linfit(pts, 3) == pytest.approx(direct[1:], rel=1e-12)


def _cpu_step_peak(device):
    cfg, shape = _smoke("train_4k")
    cfg = cfg.replace(param_dtype="float32")
    ocfg = OptimConfig()
    if device == "meta":
        state, _ = steps.abstract_state(cfg, ocfg)
    else:
        state, _ = steps.concrete_state(torch.Generator().manual_seed(0),
                                        cfg, ocfg)
    gen = torch.Generator().manual_seed(1)
    batch = {k: (torch.randint(0, cfg.vocab_size, s, generator=gen)
                 if device == "cpu" else torch.empty(s, dtype=dt,
                                                     device="meta"))
             for k, (s, dt) in api.batch_specs(cfg, shape).items()}
    step = steps.make_train_step(cfg, ocfg, TrainConfig(), shape, None)
    out, mode = DR.count(step, state, batch)
    if device == "cpu":
        assert math.isfinite(float(out[1]["loss"]))
    return mode


def test_live_bytes_peak_of_a_cpu_step_equals_the_meta_steps():
    cpu, meta = _cpu_step_peak("cpu"), _cpu_step_peak("meta")
    assert cpu.peak > 0
    assert cpu.peak == meta.peak
    assert (cpu.flops, cpu.dot_flops, cpu.bytes_accessed) == (
        meta.flops, meta.dot_flops, meta.bytes_accessed)


def test_products_count_a_devices_share():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    m, k, n = 64, 32, 16
    with DR.fake_world(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        a = torch.empty(m, k, device="meta")
        b = torch.empty(k, n, device="meta")
        rep = [distribute_tensor(t, mesh, [Replicate()], src_data_rank=None)
               for t in (a, b)]
        _, full = DR.count(torch.mm, *rep)
        rows = distribute_tensor(a, mesh, [Shard(0)], src_data_rank=None)
        _, quarter = DR.count(torch.mm, rows, rep[1])
    assert full.dot_flops == 2.0 * m * n * k
    assert quarter.dot_flops == 2.0 * m * n * k / 4
    _, plain = DR.count(torch.mm, a, b)
    assert plain.dot_flops == full.dot_flops


GLOO_CUT = {"greedyml-facility": dict(objective="facility", n=256, d=16,
                                      k=6),
            "greedyml-kcover": dict(objective="kcover", n=256,
                                    universe=1024, k=6)}


def _counts(res):
    return {"flops": res["flops"], "dot": res["dot_flops"],
            "kernel": res["kernel_flops"], "bytes": res["bytes_accessed"],
            "collectives": res["collectives"]["ops"],
            "memory": res["memory"],
            "ids": res["solution"].ids.tolist()}


def _gloo_rank(rank):
    out = {}
    for name, spec in GLOO_CUT.items():
        res = DR.run_technique(name, "single", "cpu", radices=(2, 2),
                               spec=spec, mesh_cls=TMESH.TreeMesh,
                               data_rank=0)
        out[name] = _counts(res)
    return out


def test_technique_counts_on_a_fake_world_equal_rank0_of_gloo_ranks():
    ranks = run_ranks(_gloo_rank, 4, timeout=240)
    with DR.fake_world(4):
        fake = {name: _counts(DR.run_technique(name, "single", "cpu",
                                               radices=(2, 2), spec=spec))
                for name, spec in GLOO_CUT.items()}
    assert fake == ranks[0]
    assert all(fake[n]["flops"] > 0 and fake[n]["kernel"] > 0
               for n in fake)


@pytest.mark.parametrize("name,degree", [("greedyml-kcover", 2),
                                         ("greedyml-facility", 3)])
def test_technique_fit_in_k_against_direct_counts(name, degree):
    """The reference's 3-point quadratic fit in k (kept as
    `probe_technique_cell`) against direct counts. The gathered bytes are
    linear in k and kcover's node steps (k steps over b·k candidates'
    words) quadratic: the fit predicts them exactly. Facility's nodes
    take k steps over a (b·k)² matrix, cubic in k: the fit misses, and a
    4-point cubic fit predicts them exactly (the reference's quadratic
    model holds for XLA's count, which takes its loop's body once)."""
    spec = dict(GLOO_CUT[name], n=512)
    with DR.fake_world(4):
        fit = DR.probe_technique_cell(name, "single", "cpu", ks=(2, 4, 8),
                                      k_full=12, radices=(2, 2), spec=spec)
        direct = {k: DR.run_technique(name, "single", "cpu", k_override=k,
                                      radices=(2, 2), spec=spec)
                  for k in (2, 4, 8, 12, 16)}
    assert fit["collective_moved_bytes"] == pytest.approx(
        direct[12]["collectives"]["moved_bytes"], rel=1e-12)
    if degree == 2:
        assert fit["flops"] == pytest.approx(direct[12]["flops"], rel=1e-12)
        return
    assert fit["flops"] < direct[12]["flops"] * (1 - 1e-3)
    import numpy as np
    ks = (2, 4, 8, 16)
    coef = np.polyfit(ks, [direct[k]["flops"] for k in ks], 3)
    assert np.polyval(coef, 12) == pytest.approx(direct[12]["flops"],
                                                 rel=1e-9)


REF_RECORD_KEYS = {"arch", "shape", "mesh", "devices", "per_device",
                   "hlo_bytes", "lower_s", "compile_s", "estimated",
                   "probe_s", "ok"}


def test_dryrun_main_writes_the_reference_keys_and_reprobe_refills(tmp_path):
    recs = DR.main(["--only", "smollm-135m:decode_32k", "--mesh", "single",
                    "--out", str(tmp_path)])
    assert len(recs) == 1 and recs[0]["ok"], recs
    path = tmp_path / "smollm-135m__decode_32k__single.json"
    rec = json.loads(path.read_text())
    assert REF_RECORD_KEYS <= set(rec)
    assert rec["hlo_bytes"] is None
    pd = rec["per_device"]
    assert {"flops_hlo_static", "bytes_accessed", "memory",
            "collectives_static"} <= set(pd)
    assert set(pd["memory"]) == {"argument_bytes", "output_bytes",
                                 "temp_bytes", "alias_bytes", "total_bytes"}
    assert {"ops", "moved_bytes", "result_bytes"} <= set(
        pd["collectives_static"])
    est = rec["estimated"]
    assert {"method", "points", "n_micro", "flops",
            "collective_moved_bytes", "bytes_accessed"} <= set(est)
    assert est["flops"] > 0 and est["n_micro"] == 1
    stripped = dict(rec)
    del stripped["estimated"]
    path.write_text(json.dumps(stripped))
    RP.main(["--out", str(tmp_path), "--device", "cpu"])
    back = json.loads(path.read_text())
    assert back["estimated"]["flops"] == est["flops"]
    assert back["estimated"]["bytes_accessed"] == est["bytes_accessed"]
    # the sweep table's row: the memory term from the fused floor to the
    # unfused bound
    row = [r for r in HC.sweep_table(str(tmp_path)).splitlines()
           if r.startswith("| smollm-135m:decode_32k |")]
    assert len(row) == 1
    t = HC.terms(back)
    floor = HC.memory_floor(back)
    assert 0 < floor < t["t_memory"]
    assert f"| {floor:.3g} – {t['t_memory']:.3g} |" in row[0]


def test_list_clis_print_the_sweeps_jobs(capsys):
    assert DR.main(["--technique", "--list"]) == []
    cells = [f"{a}:{s}" for a, s, skip in TR.cells() if skip is None]
    assert capsys.readouterr().out.split() == cells + [
        f"{t}:selection" for t in DR.TECHNIQUE_CELLS]
    assert HC.main(["--list"]) == {}
    assert capsys.readouterr().out.split() == sorted(HC.EXPERIMENTS)


def test_hillclimb_smollm_dp_only_returns_both_records(monkeypatch):
    # the experiment at smollm-135m's full width, depth cut 30 → 2 for
    # the test's time (the chip script runs it whole)
    cfg_fn = DR._cell_cfgs
    monkeypatch.setattr(DR, "_cell_cfgs", lambda a: (
        (lambda c, o: (c.replace(num_layers=2), o))(*cfg_fn(a))))
    out = HC.run_experiment("smollm_dp_only")
    assert set(out) == {"baseline", "dp_only"}
    for rec in out.values():
        t = HC.terms(rec)
        assert set(t) == {"mem_gib", "t_compute", "t_memory",
                          "t_collective"}
        assert all(v > 0 for v in t.values())
    assert out["dp_only"]["estimated"]["n_micro"] == 1
    assert out["baseline"]["estimated"]["n_micro"] == 16


# ---------------------------------------------------------------------------
# Exact equalities
# ---------------------------------------------------------------------------


def test_cells_and_technique_cells_equal_reference(ref):
    d = ref.data()
    assert [list(c) for c in TR.cells(include_skipped=True)] == d["cells"]
    assert DR.TECHNIQUE_CELLS == d["technique"]


@pytest.mark.parametrize("arch", sorted(TR.ARCHS))
def test_cell_cfgs_remat_and_shrink_equal_reference(ref, arch):
    want = ref.data()["cfgs"][arch]
    cfg, ocfg = DR._cell_cfgs(arch)
    assert (ocfg.name, ocfg.compress_grads) == (want["opt"], want["compress"])
    assert cfg.param_count() == want["params"]
    assert cfg.param_dtype == want["param_dtype"] == "bfloat16"
    assert DR._remat(cfg) == want["remat"]
    assert [[DR._shrink(cfg, r).num_layers, DR._shrink(cfg, r).encoder_layers]
            for r in (1, 2)] == want["shrink"]
    assert [DR._opt_flops_per_device(cfg, d) for d in (256, 512)] == \
        want["opt_flops"]


def test_num_microbatches_of_every_train_cell_equal_reference(ref):
    want = ref.data()["n_micro"]
    got = {}
    for kind in ("single", "multi"):
        with DR.fake_world(DR.MESH_DEVICES[kind]):
            mesh = DR.production_mesh(kind)
            for a, s, skip in TR.cells():
                if skip is None and TR.get_shape(s).kind == "train":
                    got[f"{a}:{s}:{kind}"] = steps.num_microbatches(
                        TR.get_shape(s), mesh, TrainConfig())
    assert got == want and len(got) == 2 * 10


def test_fits_equal_reference(ref):
    d = ref.data()
    assert list(DR._linfit(LIN_PTS, 7)) == d["lin"]
    assert list(DR._quadfit(QUAD_PTS, 256)) == pytest.approx(d["quad"],
                                                             rel=1e-12)


def test_moved_bytes_equal_parse_collectives(ref):
    want = ref.data()["colls"]
    got = DR.summarize_collectives([
        {"kind": k, "result_bytes": b, "group": g} for k, b, g in
        COLL_RECORDS])
    assert got["ops"] == want["ops"]
    assert got["moved_bytes"] == want["moved_bytes"]
    assert got["result_bytes"] == want["result_bytes"]


def test_terms_equal_reference_under_the_same_hw(ref):
    assert HC.terms(TERMS_REC) == ref.data()["terms"]
    # the port's HW is the H100 SXM5's datasheet, not the reference's TPU
    assert HC.HW == {"flops": 989.4e12, "hbm": 3.35e12, "link": 50e9}


@pytest.mark.parametrize("cell", CELLS)
def test_argument_bytes_a_device_equal_reference(ref, cell):
    want = ref.data()["cells_res"][cell]["memory"]["argument_bytes"]
    if cell in TECH_CUT:
        spec = TECH_CUT[cell]
        res = port_technique(cell)
        n = spec["n"] // 256
        width = spec["d"] * 4 if cell.endswith("facility") else (
            spec["universe"] // 32 * 4)
        pay = n * width
        # the payload shard exactly (1,024 B for facility), then ids int64
        # (int32 in the reference) and the valid mask (bool in both)
        assert res["memory"]["argument_bytes"] == pay + 8 * n + n
        assert want == pay + 4 * n + n
        return
    rec, wide = port_cell(cell)
    got = rec["per_device"]["memory"]["argument_bytes"] - wide
    if cell == "decode_32k":
        got += 4        # the reference's int32 cache index
    assert got == want, (cell, rec["per_device"]["memory"], wide)


# ---------------------------------------------------------------------------
# Flops a device, as a ratio
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS + SPLIT_CELLS)
def test_flops_a_device_against_reference(ref, cell):
    res = ref.data()["cells_res"][cell]
    if cell in TECH_CUT:
        port = port_technique(cell)["flops"]
        ratio = port / res["flops_unrolled"]
        print(f"{cell}: port/reference {ratio:.3f} (every scan unrolled); "
              f"against the reference's own estimate, which counts its "
              f"greedy loop's body once: {port / res['flops']:.3f}")
        assert BAND[0] <= ratio <= BAND[1], (cell, ratio)
        return
    if cell in SPLIT_CELLS:
        ratio = port_split_cell(cell.split(":")[1]) / res["flops"]
        print(f"{cell}: port/reference {ratio:.3f} a device of the 16×16 "
              f"mesh")
        assert BAND[0] <= ratio <= BAND[1], (cell, ratio)
        return
    one = port_cell(cell, "world1")[0]["estimated"]["flops"]
    ratio1 = one / res["flops_world1"]
    mesh = port_cell(cell)[0]["estimated"]["flops"]
    ratio = mesh / res["flops"]
    print(f"{cell}: port/reference {ratio1:.3f} at world 1, {ratio:.3f} "
          f"a device of the 16×16 mesh")
    assert BAND[0] <= ratio1 <= BAND[1], (cell, ratio1)
    # the finding: outside the band over the mesh, above it (W2)
    assert (cell in REPLICATED_ON_THE_MESH) == (ratio > BAND[1]), (cell,
                                                                   ratio)
