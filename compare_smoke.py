"""Compare two runs of `chip_smoke.py` phase by phase: every value field
(roots, values, digests, ids, merges, tokens, losses, launch and
selection counts, equality flags) of a phase both runs print must be
equal; timing fields (ms, seconds, rates, bytes, busy shares, measured
flop rates) are skipped.
A count that a host clock drives (a served stream's admitted batches, a
profiler's launch samples) may differ between runs of the same code.

    python compare_smoke.py PARENT_STDOUT CHANGE_STDOUT

Prints each differing field and the number compared; exits 1 when any
field differs.
"""
import json
import re
import sys

VALUE = re.compile(r"root|value|digest|ids|merge|token|loss|select|solution"
                   r"|equal|differing|mismatch|gain|kept|within|count|launch",
                   re.I)
TIMING = re.compile(r"ms|seconds|_s$|wall|busy|time|rate|per_s|p50|p99|gap"
                    r"|qps|throughput|tok_s|bytes|peak|mean_batch|batches"
                    r"|idle|host|tflops", re.I)


def phases(path):
    """{phase: its first JSON line} of one run's standard output."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                d = json.loads(line)
            except ValueError:
                continue
            if "phase" in d:
                out.setdefault(d["phase"], d)
    return out


def fields(d, path=""):
    """(path, leaf) of a JSON tree; a list of scalars is one leaf."""
    if isinstance(d, dict):
        for k, v in d.items():
            yield from fields(v, f"{path}/{k}")
    elif isinstance(d, list) and not any(isinstance(x, (dict, list))
                                         for x in d):
        yield path, d
    elif isinstance(d, list):
        for i, v in enumerate(d):
            yield from fields(v, f"{path}[{i}]")
    else:
        yield path, d


def compare(parent, change):
    """(fields compared, [(phase, path, parent's, change's)] differing)."""
    a, b = phases(parent), phases(change)
    n, diff = 0, []
    for ph in sorted(set(a) & set(b)):
        fa, fb = dict(fields(a[ph])), dict(fields(b[ph]))
        for k, v in fa.items():
            if (k not in fb or not VALUE.search(k)
                    or TIMING.search(k.split("/")[-1])):
                continue
            n += 1
            if v != fb[k]:
                diff.append((ph, k, v, fb[k]))
    return n, diff, sorted(set(a) ^ set(b))


def main(argv=None) -> int:
    parent, change = (argv or sys.argv[1:])[:2]
    n, diff, apart = compare(parent, change)
    for ph, k, v, w in diff:
        print(f"differs {ph} {k}: {str(v)[:120]} | {str(w)[:120]}")
    print(f"{n} value fields compared, {len(diff)} differing; phases in "
          f"one run only: {apart}")
    return 1 if diff else 0


if __name__ == "__main__":
    sys.exit(main())
