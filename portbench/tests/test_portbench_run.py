"""A run's result line, its refusals, and the check for JAX."""

import io
import json
import os
import shutil
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest

from portbench import harness
from portbench.conftest import tiny

ROOT = harness.ROOT
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _tiny_run(name, seconds=0.3):
    cell, config, traffic = tiny(name)
    return harness.run_cell(cell, config, traffic, 2**31 + 99, seconds, False, "cpu",
                            time.perf_counter(), harness.benchmark(ROOT))


def test_last_line_keys_and_checks_last():
    """Every key the driver reads, `checks` last; the checks repeated as
    the last lines of standard error."""
    from portbench import run as run_py

    result = _tiny_run("main-resident")
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        run_py.emit(result)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == KEYS
    assert line["attempted"] >= 1 and 0 <= line["failed"] <= line["attempted"]
    assert set(line["metrics"]) == {"resident_frames_per_s", "resident_pass_p95_ms", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    tail = err.getvalue().strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_streamed_cell_reports_its_metrics():
    result = _tiny_run("observables-streamed", seconds=0.2)
    assert set(result["metrics"]) == {"streamed_frames_per_s", "setup_s"}
    run = result["_run"]
    assert run.stage_batches > 0 and run.stage_totals["decode_wait"] >= 0


def test_no_card_no_result(tmp_path):
    """Without a CUDA card run.py exits non-zero and prints no result."""
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "main-resident",
                        "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and "{" not in r.stdout


def test_benchmark_alone_is_no_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, a run
    fails: the program is not part of the benchmark."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.'); from portbench import harness; "
            "from portbench.conftest import tiny; c, g, t = tiny('main-resident'); "
            "harness.run_cell(c, g, t, 1, 0.1, False, 'cpu', time.perf_counter())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode != 0 and "groan_rs_tpu_torch" in r.stderr


def test_jax_check_compares_whole_top_level_names():
    """A run loads nothing of JAX or the JAX package; the check compares
    each loaded module's name before its first dot, whole."""
    code = r"""
import sys, time, types
sys.path.insert(0, %r)
from portbench import harness
from portbench.conftest import tiny
c, g, t = tiny("main-resident")
res = harness.run_cell(c, g, t, 5, 0.1, False, "cpu", time.perf_counter())
assert "groan_rs_tpu_torch" in sys.modules
print("after run", harness.forbidden_modules())
sys.modules["groan_rs_tpu_torchx"] = types.ModuleType("groan_rs_tpu_torchx")
sys.modules["jaxlibrary"] = types.ModuleType("jaxlibrary")
print("near names", harness.forbidden_modules())
sys.modules["jax.numpy"] = types.ModuleType("jax.numpy")
sys.modules["groan_rs_tpu.ops"] = types.ModuleType("groan_rs_tpu.ops")
print("real names", harness.forbidden_modules())
try:
    harness.run_cell(c, g, t, 5, 0.1, False, "cpu", time.perf_counter())
    print("refused False")
except harness.BenchError:
    print("refused True")
""" % ROOT
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert lines == ["after run []", "near names []",
                     "real names ['groan_rs_tpu', 'jax']", "refused True"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["main-resident", "observables-streamed", "main-dodec-streamed"])
def test_cell_on_the_card(cell, cuda_card):
    """A short run of each cell on the card: the result line, `correct`."""
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                        str(2**31 + 17), "--seconds", "2", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(line) == KEYS and line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0
