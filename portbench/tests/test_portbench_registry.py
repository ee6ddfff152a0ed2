"""Every configuration, traffic mix, cell and metric is a file of its own,
found by name; BENCHMARK.json agrees with them; a new file is picked up
with no edit to any file that is there."""

import json
import os
import re
import shutil

import pytest

from portbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_file_parses_and_resolves():
    for kind in ("configs", "traffic", "workloads"):
        for name in harness.names(kind):
            assert isinstance(harness.load_json(kind, name), dict)
    for name in harness.names("workloads"):
        cell, config, traffic = harness.resolve_cell(name)
        assert cell["name"] == name and config["name"] == cell["config"]
        assert traffic["entry"] in ("resident", "streamed")
        assert int(traffic["frames"]) <= int(config["frames"])
    for name in harness.names("metrics", ".py"):
        mod = harness.metric_reader(name)
        assert mod.NAME == name and callable(mod.read)


def test_benchmark_json_matches_the_files():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and bench["command"][1] == "portbench/run.py"
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        cfg = harness.load_json("configs", c["name"])
        assert c["reduced"] == cfg["reduced"] and c["source"] == cfg["source"]
    for w in bench["workloads"]:
        cell = harness.load_json("workloads", w["name"])
        for k in ("config", "traffic", "chips", "why"):
            assert w[k] == cell[k], (w["name"], k)
        assert len(w["why"]) <= 200
    cells = {w["name"] for w in bench["workloads"]}
    for key in ("end_to_end", "per_layer"):
        for m in bench[key]:
            mod = harness.metric_reader(m["name"])
            assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (m["unit"], m["better"], m["source"])
            if key == "per_layer":
                assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
            assert set(m.get("workloads", cells)) <= cells
    names = ([c["name"] for c in bench["configs"]] + list(cells)
             + [m["name"] for k in ("end_to_end", "per_layer") for m in bench[k]])
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for w in cells:   # every cell reports setup_s, another end-to-end and a per-layer metric
        e2e = [m["name"] for m in harness.cell_metrics(bench, w, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(bench, w, True)


def test_limits_cover_every_compared_output():
    from portbench.reference import judge

    for name in harness.names("workloads"):
        cell, _, traffic = harness.resolve_cell(name)
        outs = {judge.output_name(c) for c in traffic["analysis"]}
        assert all(judge.oracle(c["call"]).KIND in judge.ERRORS or hasattr(
            judge.oracle(c["call"]), "error") for c in traffic["analysis"])
        assert set(cell["limits"]) == outs, name


def test_every_oracle_generator_and_argument_kind_resolves():
    """Each oracle file declares how it is compared; each configuration
    names a generator file with `make`; each argument kind a traffic file
    uses has its file."""
    from portbench.reference import judge

    for call in judge.oracle_names():
        mod = judge.oracle(call)
        assert callable(mod.oracle) and (mod.KIND in judge.ERRORS or hasattr(mod, "error"))
    for name in harness.names("configs"):
        cfg = harness.load_json("configs", name)
        assert callable(harness.load_module("gen", cfg["generator"]).make)

    def kinds(v):
        if isinstance(v, dict):
            if len(v) == 1 and os.path.exists(os.path.join(harness.HERE, "args",
                                                          f"{next(iter(v))}.py")):
                return {next(iter(v))}
            return set().union(*(kinds(x) for x in v.values())) if v else set()
        if isinstance(v, list):
            return set().union(*(kinds(x) for x in v)) if v else set()
        return set()

    used = set()
    for name in harness.names("traffic"):
        for c in harness.load_json("traffic", name)["analysis"]:
            used |= kinds(c.get("args", [])) | kinds(c.get("kwargs", {}))
    assert used == {"site", "cylinder", "system"}
    for k in used:
        assert callable(harness.load_module("args", k).program)


def test_a_dropped_in_file_is_picked_up(tmp_path, monkeypatch):
    """A later change adds a configuration, a traffic mix, a cell and a
    metric as new files only."""
    copy = tmp_path / "portbench"
    shutil.copytree(harness.HERE, copy, ignore=shutil.ignore_patterns("build", "__pycache__"))
    monkeypatch.setattr(harness, "HERE", str(copy))
    shutil.copy(copy / "configs" / "memprot-1m-rect.json", copy / "configs" / "dummy-cfg.json")
    cfg = json.loads((copy / "configs" / "dummy-cfg.json").read_text())
    cfg["name"] = "dummy-cfg"
    (copy / "configs" / "dummy-cfg.json").write_text(json.dumps(cfg))
    (copy / "traffic" / "dummy-mix.json").write_text(json.dumps(
        {"entry": "resident", "frames": 4, "batch": 2,
         "analysis": [{"call": "add_com", "args": ["Protein"], "kwargs": {"name": "com"}}]}))
    (copy / "workloads" / "dummy-cell.json").write_text(json.dumps(
        {"name": "dummy-cell", "config": "dummy-cfg", "traffic": "dummy-mix", "chips": 1,
         "why": "a test", "limits": {"com": 1e-3}}))
    (copy / "metrics" / "dummy.metric.py").write_text(
        'NAME, UNIT, BETTER, SOURCE = "dummy.metric", "count", "lower", "program_counter"\n'
        'LAYER, MOVES = "device", "setup_s"\n\n\ndef read(ctx):\n    return 42.0\n')
    assert "dummy-cell" in harness.names("workloads")
    assert "dummy.metric" in harness.names("metrics", ".py")
    cell, config, traffic = harness.resolve_cell("dummy-cell")
    assert config["name"] == "dummy-cfg" and traffic["frames"] == 4
    assert harness.metric_reader("dummy.metric").read(None) == 42.0
    bench = _bench()
    bench["per_layer"].append({"name": "dummy.metric", "workloads": ["dummy-cell"]})
    assert [m["name"] for m in harness.cell_metrics(bench, "dummy-cell", True)] == [
        "dummy.metric"]
    with pytest.raises(harness.BenchError):
        harness.resolve_cell("no-such-cell")


def test_a_dropped_in_oracle_generator_and_argument_kind_are_picked_up(tmp_path, monkeypatch):
    """A later change adds an analysis call's oracle, a generator and an
    argument kind as new files only."""
    import types

    from portbench.reference import judge

    copy = tmp_path / "portbench"
    shutil.copytree(harness.HERE, copy, ignore=shutil.ignore_patterns("build", "__pycache__"))
    monkeypatch.setattr(harness, "HERE", str(copy))
    monkeypatch.setattr(judge, "ORACLE_DIR", str(copy / "reference" / "oracles"))
    (copy / "gen" / "dummy_gen.py").write_text(
        "def make(config, seed, device, n_frames=None):\n"
        "    return ('dummy', config['n_atoms'], seed, n_frames)\n")
    (copy / "reference" / "oracles" / "add_dummy.py").write_text(
        'KIND = "abs"\nOUTPUT = "dummy"\n\n\ndef oracle(fr, args, kwargs, tol):\n'
        '    return args[0] * 2\n')
    (copy / "args" / "dummy_arg.py").write_text(
        "def program(value, ctx):\n    return (value, ctx.system)\n")
    assert "add_dummy" in judge.oracle_names()
    cfg = {"generator": "dummy_gen", "n_atoms": 7}
    assert harness.make_system(cfg, 3, "cpu", n_frames=2) == ("dummy", 7, 3, 2)
    call = {"call": "add_dummy", "args": [21]}
    assert judge.output_name(call) == "dummy"
    assert judge.reference_outputs(None, [call]) == {"dummy": 42}
    numbers = {}
    import torch

    judge.judge_block({"dummy": torch.tensor([41.5])}, None, [call], numbers,
                      {"dummy": torch.tensor([42.0])})
    assert numbers == {"dummy": 0.5}
    ctx = types.SimpleNamespace(system="the System")
    assert harness.program_args({"reference": {"dummy_arg": 5}, "name": "x"}, ctx) == {
        "reference": (5, "the System"), "name": "x"}
    with pytest.raises(KeyError):
        judge.oracle("add_no_such_call")
    with pytest.raises(harness.BenchError):
        harness.make_system({"generator": "no_such_gen"}, 1, "cpu")
