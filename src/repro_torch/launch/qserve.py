"""Selection-query serving driver, the multi-tenant front door of the
serving engine (answers `src/repro/launch/qserve.py`).

    PYTHONPATH=src python -m repro_torch.launch.qserve --tenants 8 \\
        --qps 200 --duration 5

Spins up a synthetic multi-tenant workload: each tenant owns a candidate
pool and a registered objective (tenants cycle facility / kmedoid /
coverage / satcover / mmr) and submits one-shot selection queries of
varied k at a steady ``--qps`` into one shared `serving.QueryEngine`,
from one thread: each submission's pool is generated on the host, a
cost the measurement includes, and the queue drains whenever
``--batch`` (default 16) queries wait. The engine stacks
rule-compatible queries into single resident-loop dispatches; the
driver reports per-tenant p50/p99 latency, served queries/s, the mean
admitted batch size and the dispatches of each batch.

``--device`` (default ``cuda``; ``cpu`` runs the plain path) places the
engine; without a GPU, ``cuda`` raises. ``--smoke`` checks the serving
surface: N mixed queries in (≥ 3 objectives, varied k, one constrained)
→ N results out, every batched selection equal to its solo greedy() run
(ids, valid, evals), every admitted batch ONE counted dispatch — on the
card exactly one greedy_loop_resident launch, on the CPU one call — the
constrained query run solo and selecting, QueueFull at the queue bound,
and a TenantSession stream equal to stream_select_continuous. Exits
non-zero on any mismatch.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

OBJ_CYCLE = ("facility", "kmedoid", "coverage", "satcover", "mmr")


def _fmt_ms(v) -> str:
    """A latency percentile for printing (None: no completed query)."""
    return "n/a" if v is None else f"{v:.1f}ms"


def _pool(name, n, d, universe, seed):
    """A candidate pool in the objective's payload representation, on
    the host: every 11th slot invalid."""
    import torch
    from repro_torch.data.synthetic import gen_images, gen_kcover, \
        pack_bitmaps
    from repro_torch.kernels.rules import to_words
    if name == "coverage":
        pay = to_words(pack_bitmaps(gen_kcover(n, universe, seed=seed),
                                    universe))
    else:
        pay = torch.as_tensor(gen_images(n, d, classes=8, seed=seed))
    ids = torch.arange(n)
    valid = (torch.arange(n) % 11) != 0
    return ids, pay, valid


def _query(name, k, n, d, universe, seed, tenant, **kw):
    from repro_torch.serving import Query
    ids, pay, valid = _pool(name, n, d, universe, seed)
    return Query(name, k, ids, pay, valid, tenant=tenant,
                 universe=universe if name == "coverage" else 0, **kw)


def _device(args):
    from repro_torch.runtime.device import resolve_device
    return resolve_device(None if args.device == "cuda" else args.device)


def run(args) -> int:
    from repro_torch.serving import QueryEngine, QueueFull
    rng = np.random.default_rng(args.seed)
    eng = QueryEngine(device=_device(args), max_batch=args.batch or None)
    tenant_objs = [OBJ_CYCLE[t % len(OBJ_CYCLE)]
                   for t in range(args.tenants)]
    period = 1.0 / args.qps if args.qps > 0 else 0.0
    t_end = time.perf_counter() + args.duration
    next_t = time.perf_counter()
    n_sub = 0
    results = {}
    while time.perf_counter() < t_end:
        t = n_sub % args.tenants
        q = _query(tenant_objs[t], int(rng.integers(4, args.k + 1)),
                   args.n, args.d, args.universe, args.seed + t,
                   f"tenant{t}")
        try:
            eng.submit(q)
        except QueueFull:
            results.update(eng.drain())
            eng.submit(q)
        n_sub += 1
        if eng.pending >= (args.batch or 16):
            results.update(eng.drain())
        next_t += period
        lag = next_t - time.perf_counter()
        if lag > 0:
            time.sleep(lag)
    results.update(eng.drain())
    snap = eng.metrics.snapshot()
    sizes = [b["size"] for b in eng.metrics.batches]
    qps = snap["queries_per_s"]
    qps_s = f"{qps:.0f}" if qps else "n/a"
    print(f"qserve tenants={args.tenants} submitted={n_sub} "
          f"served={snap['total_queries']} batches={snap['total_batches']} "
          f"mean_B={np.mean(sizes):.1f} "
          f"p50={_fmt_ms(snap['p50_ms'])} p99={_fmt_ms(snap['p99_ms'])} "
          f"served_qps={qps_s}")
    for t in sorted(snap["tenants"]):
        s = snap["tenants"][t]
        obj_name = (tenant_objs[int(t[6:])] if t.startswith("tenant")
                    else "?")
        print(f"  {t:>10s} [{obj_name}] served={s['completed']} "
              f"p50={_fmt_ms(s['p50_ms'])} p99={_fmt_ms(s['p99_ms'])}",
              flush=True)
    return 0 if len(results) == n_sub else 1


def smoke(args) -> int:
    """The serving surface on a tiny mixed workload (module docstring)."""
    import torch
    from repro_torch.core.constraints import PartitionMatroid
    from repro_torch.core.greedy import greedy
    from repro_torch.core.objective import make_objective
    from repro_torch.data.synthetic import gen_stream
    from repro_torch.kernels import counters
    from repro_torch.serving import (Query, QueryEngine, QueueFull,
                                     TenantSession)
    from repro_torch.streaming import stream_select_continuous

    rc = 0
    dev = _device(args)
    eng = QueryEngine(device=dev, queue_cap=64)
    universe = 384
    specs = [("facility", 5, 96, 1), ("facility", 9, 120, 2),
             ("kmedoid", 12, 96, 3), ("coverage", 7, 96, 4),
             ("satcover", 6, 120, 5)]
    qids = [eng.submit(_query(name, k, n, 32, universe, seed, name))
            for name, k, n, seed in specs]
    # a constrained query must run solo and still be served
    ids, pay, valid = _pool("facility", 96, 32, universe, 9)
    con = PartitionMatroid(torch.as_tensor(np.arange(96) % 3, device=dev),
                           torch.as_tensor([2, 2, 2], device=dev))
    qc = eng.submit(Query("facility", 6, ids, pay, valid,
                          tenant="constrained", constraint=con))
    before = counters.snapshot()
    results = eng.drain()
    resident = counters.dispatches(before, counters.snapshot(), dev,
                                   prefix="greedy_loop_resident")
    if len(results) != len(specs) + 1:
        print(f"FAIL: {len(specs) + 1} queries in, {len(results)} out")
        return 1
    for qid, (name, k, n, seed) in zip(qids, specs):
        ids, pay, valid = _pool(name, n, 32, universe, seed)
        obj = make_objective(name,
                             universe=universe if name == "coverage" else 0,
                             device=dev)
        solo = greedy(obj, ids, pay, valid, k)
        r = results[qid]
        same = (torch.equal(r.solution.ids.cpu(), solo.ids.cpu())
                and torch.equal(r.solution.valid.cpu(), solo.valid.cpu())
                and int(r.solution.evals) == int(solo.evals))
        if not (same and r.batched):
            print(f"FAIL: {name} k={k} batched={r.batched} parity={same}")
            rc |= 1
    if results[qc].batched or not bool(results[qc].solution.valid.any()):
        print("FAIL: constrained query should run solo and select")
        rc |= 1
    disp = [b["dispatches"] for b in eng.metrics.batches]
    if not (disp and all(d == 1 for d in disp) and resident == len(disp)):
        print(f"FAIL: batched dispatch counts {disp} and {resident} "
              "resident dispatches, expected one each")
        rc |= 1
    # bounded queue backpressure
    tiny = QueryEngine(device=dev, queue_cap=2)
    for seed in (0, 1):
        tiny.submit(_query("facility", 4, 96, 32, universe, seed, "t"))
    try:
        tiny.submit(_query("facility", 4, 96, 32, universe, 2, "t"))
        print("FAIL: queue bound not enforced")
        rc |= 1
    except QueueFull:
        pass
    # a tenant's continuous session == the one-shot continuous driver
    st = gen_stream("facility", 128, d=24, universe=universe, batch=32,
                    seed=args.seed)
    obj = make_objective("facility", device=dev)
    ground = torch.as_tensor(st.payloads, device=dev)
    sess = TenantSession("streamer", obj, 6, metrics=eng.metrics, lanes=2,
                         merge_every=2, ground=ground)
    for bids, bpay, bval in st:
        sess.push(bids, bpay, bval)
    ref_sol, _ = stream_select_continuous(obj, st, 6, lanes=2,
                                          merge_every=2, ground=ground)
    if not torch.equal(sess.query().ids.cpu(), ref_sol.ids.cpu()):
        print("FAIL: session stream diverged from continuous driver")
        rc |= 1
    snap = eng.metrics.snapshot()
    print(f"qserve smoke: {snap['total_queries']} queries, "
          f"{snap['total_batches']} batches, dispatches/batch={disp}, "
          f"resident dispatches={resident}, "
          f"stream_pushes={snap['tenants']['streamer']['stream_pushes']}")
    print("qserve smoke", "FAILED" if rc else "OK", flush=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--qps", type=float, default=200.0)
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--universe", type=int, default=384)
    ap.add_argument("--batch", type=int, default=0,
                    help="admission cap override (0: "
                         "REPRO_TORCH_SERVE_BATCH)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    _device(args)                    # raises for cuda without a card
    if args.smoke:
        return smoke(args)
    return run(args)


if __name__ == "__main__":
    raise SystemExit(main())
