"""The port's selection launchers (`repro_torch/launch/{summarize,
stream,qserve,autotune}.py`) on the CPU, held against the reference's
CLIs (`src/repro/launch/`) where both print the same thing."""
import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import summarize as j_summarize

from repro_torch.launch import autotune as t_autotune
from repro_torch.launch import qserve as t_qserve
from repro_torch.launch import stream as t_stream
from repro_torch.launch import summarize as t_summarize

SRC = Path(__file__).resolve().parents[1] / "src"
_TIME = re.compile(r" \[[0-9.]+s\]")


def _lines(out: str):
    """Printed lines with the run's own seconds taken out."""
    return [_TIME.sub("", ln) for ln in out.strip().splitlines()]


@pytest.mark.parametrize("extra", [["--engine", "lazy", "--compare"],
                                   ["--engine", "dense"]],
                         ids=["lazy-compare", "dense"])
def test_summarize_prints_the_references_lines(extra, capsys):
    argv = ["--problem", "paper-kcover", "--machines", "4",
            "--branching", "2", "--k", "16", *extra]
    j_summarize.main(argv)
    want = _lines(capsys.readouterr().out)
    t_summarize.main(argv + ["--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    assert got == want
    assert want[0].startswith("GreedyML  T(m=4, L=2, b=2) f=")
    # coverage values are exact integers
    assert re.search(r"f=\d+\.00 ", want[0])


def test_summarize_build_instance_is_the_references():
    from repro.configs import registry as JR
    cfg = JR.PROBLEMS["paper-kdom"]
    small = type(cfg)(**{**cfg.__dict__, "n": 500, "universe": 500})
    js, jd = j_summarize.build_instance(small)
    ts, td = t_summarize.build_instance(small)
    np.testing.assert_array_equal(jd, td)
    assert len(js) == len(ts) and all(
        np.array_equal(a, b) for a, b in zip(js, ts))


def test_stream_smoke_runs_on_the_cpu(capsys):
    assert t_stream.main(["--smoke", "--device", "cpu"]) == 0
    assert "stream smoke OK" in capsys.readouterr().out


def test_qserve_smoke_runs_on_the_cpu(capsys):
    assert t_qserve.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "qserve smoke OK" in out and "resident dispatches=" in out


_STREAM_ARGS = ["--objective", "facility", "--n", "512", "--d", "24",
                "--batch", "64", "--k", "8", "--order", "drift"]

_REFERENCE_STREAM = """
import argparse, json, sys
import numpy as np
from repro.launch import stream as S
argv = json.loads(sys.argv[1])
assert S.main(argv + ["--backend", "ref"]) == 0
ns = argparse.Namespace(objective="facility", n=512, d=24, universe=2048,
                        batch=64, order="drift", seed=0, backend="ref")
st, obj, ground = S._make(ns)
sol = S.stream_select(obj, st, 8, eps=0.1, ground=ground, backend="ref")
print("IDS", json.dumps(S._ids(sol).tolist()))
"""


def test_stream_default_run_prints_the_reference_clis_value(capsys):
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-c", _REFERENCE_STREAM,
                          json.dumps(_STREAM_ARGS)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert ref.returncode == 0, ref.stderr[-2000:]
    ref_lines = ref.stdout.strip().splitlines()
    want_ids = json.loads(ref_lines[-1].split(" ", 1)[1])
    assert t_stream.main(_STREAM_ARGS + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    # the value, |S| and mode fields; the rate and seconds are the run's
    strip = re.compile(r" arrivals/s=\d+ \[[0-9.]+s\]")
    assert (strip.sub("", got[0]).rstrip()
            == strip.sub("", ref_lines[0]).rstrip())
    sol = _select(**_namespace(), device="cpu")[0]
    assert t_stream._ids(sol).tolist() == want_ids


def _select(**kw):
    args = argparse.Namespace(**kw)
    return t_stream.select(args, *t_stream._make(args)[1:])


def _namespace():
    return dict(objective="facility", n=512, d=24, universe=2048, batch=64,
                k=8, eps=0.1, order="drift", seed=0, continuous=False,
                distributed=False, lanes=4, merge_every=4, window=0,
                stride=0, ckpt_dir=None, ckpt_every=0, resume=False,
                compare=False)


def test_stream_distributed_equals_continuous():
    """--distributed over 2 spawned gloo ranks gives the --continuous
    run's merges and root at the same lanes and merge period."""
    base = {**_namespace(), "device": "cpu", "lanes": 2, "merge_every": 2}
    cont = _select(**{**base, "continuous": True})
    dist = _select(**{**base, "distributed": True})
    assert dist[1]["merges"] == cont[1]["merges"]
    assert torch.equal(dist[0].ids, cont[0].ids)
    assert dist[2] == "distributed[2 lanes]"


def test_qserve_run_serves_every_query(capsys):
    rc = t_qserve.main(["--device", "cpu", "--duration", "1", "--qps",
                        "20", "--tenants", "4", "--n", "96", "--k", "6"])
    out = capsys.readouterr().out
    m = re.search(r"submitted=(\d+) served=(\d+)", out)
    assert rc == 0 and m and m.group(1) == m.group(2) and int(m.group(1))
    assert "p50=" in out and "served_qps=" in out


@pytest.mark.parametrize("cli,argv", [
    (t_summarize, ["--k", "4"]), (t_stream, ["--smoke"]),
    (t_qserve, ["--smoke"]), (t_autotune, ["--smoke"])],
    ids=["summarize", "stream", "qserve", "autotune"])
def test_cuda_without_a_card_raises(cli, argv, monkeypatch, tmp_path):
    """No CLI falls back to the CPU: --device cuda (the default) raises
    where no CUDA device is present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv + ["--device", "cuda"])
    assert not list(tmp_path.iterdir())
