"""One run of one benchmark cell: set-up, the measured window, the
metrics, and the comparison that decides `correct`.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by name:

- `configs/<config>.json`: the system (its generator, sizes, groups,
  box, precision);
- `gen/<generator>.py`: the generator a configuration names (`make`);
- `traffic/<traffic>.json`: the mix (frames, batch, the entry the window
  drives, the analysis as a list of calls, the warm-up);
- `workloads/<cell>.json`: the cell (its configuration, its traffic, and
  the limit of each number the comparison reads);
- `metrics/<metric>.py`: one reader per metric, `read(ctx) -> float | None`;
- `args/<kind>.py`: an argument kind of the traffic's calls (`program`);
- `reference/oracles/<call>.py`: the plain oracle of each call.

`BENCHMARK.json` at the root of the checkout says which metrics each cell
reports: its `end_to_end` metrics with `--trace 0`, its `per_layer`
metrics with `--trace 1` (a metric with a `workloads` key only in those
cells).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "groan_rs_tpu")


class BenchError(RuntimeError):
    """A run that may print no result."""


# ------------------------------------------------------------------ registry
def load_json(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, f"{name}.json")
    if not os.path.exists(path):
        raise BenchError(f"no {kind[:-1]} '{name}' ({path})")
    with open(path) as f:
        return json.load(f)


def names(kind: str, suffix: str = ".json") -> list[str]:
    return sorted(f[:-len(suffix)] for f in os.listdir(os.path.join(HERE, kind))
                  if f.endswith(suffix) and not f.startswith("_"))


def load_module(kind: str, name: str):
    """The module `<kind>/<name>.py` (any name, dots included)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise BenchError(f"no {kind} module '{name}' ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader `metrics/<name>.py`."""
    return load_module("metrics", name)


def make_system(config: dict, seed: int, device, n_frames: int | None = None):
    """The system of `config` under `seed`, made by the generator the
    configuration names (`gen/<generator>.py` `make`)."""
    return load_module("gen", config["generator"]).make(config, seed, device,
                                                        n_frames=n_frames)


def benchmark(root: str = ".") -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        path = os.path.join(ROOT, "BENCHMARK.json")
    with open(path) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries cell `cell` reports in a run with/without trace."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


def resolve_cell(name: str) -> tuple[dict, dict, dict]:
    """(cell, config, traffic) of workload `name`."""
    cell = load_json("workloads", name)
    cell.setdefault("name", name)
    return cell, load_json("configs", cell["config"]), load_json("traffic", cell["traffic"])


# ------------------------------------------------------------------ the program
def program_args(value, ctx):
    """A traffic file's argument in the program's terms: a one-key object
    whose key names an argument kind (`args/<key>.py`) is that kind's
    value; lists and other objects element by element."""
    if isinstance(value, dict):
        if len(value) == 1:
            (key, v), = value.items()
            if os.path.exists(os.path.join(HERE, "args", f"{key}.py")):
                return load_module("args", key).program(v, ctx)
        return {k: program_args(v, ctx) for k, v in value.items()}
    if isinstance(value, list):
        return [program_args(v, ctx) for v in value]
    return value


def build_analysis(traffic, ctx, device):
    """The program's TrajectoryAnalysis for the traffic's list of calls;
    `ctx` holds `syn`, `state` and `system`."""
    from groan_rs_tpu_torch.models import TrajectoryAnalysis

    pipe = TrajectoryAnalysis(ctx.system, device=device, triclinic=ctx.syn.triclinic)
    for call in traffic["analysis"]:
        args = program_args(call.get("args", []), ctx)
        kwargs = program_args(call.get("kwargs", {}), ctx)
        pipe = getattr(pipe, call["call"])(*args, **kwargs)
    return pipe


# ------------------------------------------------------------------ a run
class Run:
    """The state of one run, handed to the metric readers as `ctx`."""

    def __init__(self, cell, config, traffic, seed, seconds, trace, device):
        import torch

        self.torch = torch
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        from .tracing import Spans

        self.spans = Spans()
        self.frames = int(traffic["frames"])
        self.batch = int(traffic["batch"])
        self.batches_per_pass = -(-self.frames // self.batch)
        self.passes = []          # (t0, t1) of the window's passes
        self.stage_totals = {}    # the engine's host clocks summed over the window
        self.stage_batches = 0
        self.kept = {}            # pass index -> {output: [F, ...] numpy}
        self.trace_info = None
        self.setup_s = None
        self.memory_peak = 0
        self.runner = self.dt = self.system = self.syn = self.state = None
        self.xtc = None
        self.write_s = None

    # ---------------------------------------------------------- helpers
    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def time_op(self, fn, reps: int = 5) -> float:
        """Seconds per call of `fn` on the device (CUDA events over `reps`
        calls after one warm-up call)."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / 1e3 / reps

    def time_graph(self, fn, reps: int = 20) -> float:
        """Seconds per call of `fn` on the device, where the host would
        pace it: `reps` calls captured once in a CUDA graph, the graph
        replayed between CUDA events (after warm-up calls on a side
        stream, as capture asks)."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        del graph
        return a.elapsed_time(b) / 1e3 / reps

    def sample_batch(self, n: int):
        """The first `n` frames as the program's float32 positions [n, N, 3]
        on the device and their boxes ([n, 3] or [n, 3, 3])."""
        torch = self.torch
        inv = torch.tensor(1.0 / self.syn.precision, dtype=torch.float32)
        pos = torch.stack([q.to(torch.float32) * inv.to(q.device)
                           for _, q in self.syn.grid_frames(0, n)])
        h = torch.as_tensor(self.syn.h, device=self.device)
        box = h if self.syn.triclinic else torch.diagonal(h)
        return pos, box.expand(n, *box.shape).contiguous()

    def group(self, name):
        return slice(*self.config["groups"][name])

    def run_pass(self):
        return self._pass()


def _keep_plan(seed: int, k: int):
    """Reservoir sampling of `k` passes, drawn from the seed: keep(i,
    kept) -> "add", "skip", or the kept pass that pass i replaces."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])

    def keep(i: int, kept: dict):
        if len(kept) < k:
            return "add"
        j = int(rng.integers(0, i + 1))
        return sorted(kept)[j] if j < k else "skip"

    return keep


def setup(run: Run, tmpdir: str) -> None:
    """Inputs, System, runner, entry, warm-up."""
    from .gen import xtc as xtcw

    sp = run.spans
    with sp.span("import program"):
        from groan_rs_tpu_torch import convert
        from groan_rs_tpu_torch.models import TrajectoryAnalysis  # noqa: F401  (timed here)

        if run.cuda:
            from groan_rs_tpu_torch.ops import kernels

            kernels._load()
            from groan_rs_tpu_torch.io import native

            native.get_lib()
    with sp.span("build writer"):
        xtcw.library()
    syn = run.syn = make_system(run.config, run.seed, run.device, n_frames=run.frames)
    threads = min(8, os.cpu_count() or 1)
    xtc = os.path.join(tmpdir, "traj.xtc")
    with sp.span("write input", sync=run.sync):
        t0 = time.perf_counter()
        nbytes = xtcw.write_xtc(xtc, syn.host_frames(run.frames), syn.box9, syn.precision,
                                syn.dt_ps, threads)
        run.write_s = time.perf_counter() - t0
    def prefix(n: int) -> str:
        """An XTC of the first `n` frames (the trajectory itself when n
        covers it)."""
        if n >= run.frames:
            return xtc
        path = os.path.join(tmpdir, f"first{n}.xtc")
        with sp.span("write a shorter input"):
            xtcw.write_xtc(path, syn.host_frames(n), syn.box9, syn.precision, syn.dt_ps,
                           threads)
        return path

    streamed = run.traffic["entry"] == "streamed"
    warm_xtc = prefix(int(run.traffic.get("warm_frames", run.frames))) if streamed else xtc
    print(f"input: {run.frames} frames x {syn.n} atoms, {nbytes} bytes written in "
          f"{run.write_s:.3f} s ({threads} threads)", file=sys.stderr, flush=True)
    with sp.span("system"):
        run.state = syn.state(run.traffic.get("topology"))
        run.system = convert.system_from_state(run.state, device=run.device)
        pipe = build_analysis(run.traffic, run, run.device)
        run.runner = pipe.runner()
        run.state = None
    runner, batch = run.runner, run.batch
    if run.traffic["entry"] == "resident":
        with sp.span("load_device", sync=run.sync):
            run.dt = runner.load_device(xtc, batch_size=batch)

        def one_pass():
            return runner.run(run.dt, batch_size=batch)
    elif run.traffic["entry"] == "streamed":
        def one_pass(path=xtc):
            out = runner.run(path, batch_size=batch)
            clocks = runner.engine.last_stage_seconds
            for k, v in clocks.items():
                run.stage_totals[k] = run.stage_totals.get(k, 0.0) + float(sum(v))
            run.stage_batches += len(clocks.get("stage", ()))
            return out
    else:
        raise BenchError(f"unknown entry '{run.traffic['entry']}'")
    run._pass = one_pass
    with sp.span("warm-up", sync=run.sync):
        for _ in range(int(run.traffic.get("warm_passes", 1))):
            if run.traffic["entry"] == "streamed":
                one_pass(warm_xtc)
            else:
                one_pass()
    run.stage_totals, run.stage_batches = {}, 0
    run.xtc = xtc


TRACE_TRIES = 3   # traces of the window's passes tried before a traced run fails


def window(run: Run, tmpdir: str) -> None:
    """Whole passes back to back until `seconds` have passed; keeps the
    outputs of a sample of passes drawn from the seed.  A traced run
    profiles `traced_passes` of the window's own passes from a third of
    the way in; a trace that lost records (`tracing.TraceTruncated`) is
    never read: the next passes are traced instead, and a run whose
    every try lost records fails."""
    from .tracing import TraceTruncated, profiled

    keep = _keep_plan(run.seed, int(run.traffic.get("kept_passes", 4)))
    trace_from = run.seconds / 3 if run.trace else math.inf
    trace_passes = int(run.traffic.get("traced_passes", 1))
    tries = 0
    t_w = time.perf_counter()
    i = 0
    while True:
        if run.trace and run.trace_info is None and time.perf_counter() - t_w >= trace_from:
            info = {}
            tries += 1
            try:
                with profiled(run.torch, run.spans, info, tmpdir):
                    for _ in range(trace_passes):
                        _timed_pass(run, i, keep)
                        i += 1
                run.trace_info = info
            except TraceTruncated as e:
                print(f"trace {tries} of {TRACE_TRIES} not read: {e}", file=sys.stderr,
                      flush=True)
                if tries >= TRACE_TRIES:
                    raise BenchError(f"every trace of the window lost records ({e})") from e
        else:
            _timed_pass(run, i, keep)
            i += 1
        if run.passes[-1][1] - t_w >= run.seconds and (run.trace_info or not run.trace):
            break
    run.window_s = run.passes[-1][1] - t_w


def _timed_pass(run: Run, i: int, keep) -> None:
    t0 = time.perf_counter()
    out = run._pass()
    run.sync()
    t1 = time.perf_counter()
    run.passes.append((t0, t1))
    run.spans.add("pass", t0, t1)
    slot = keep(i, run.kept)
    if slot != "skip":
        if slot != "add":
            del run.kept[slot]
        run.kept[i] = _outputs(run, out)


def _outputs(run: Run, out: dict) -> dict:
    from .reference.judge import output_name

    # the pass returns fresh arrays: keep them without a copy inside the window
    return {output_name(c): out[output_name(c)]
            for c in run.traffic["analysis"]}


def free_program(run: Run) -> None:
    run.runner = run.dt = run.system = None
    run._pass = None
    gc.collect()
    if run.cuda:
        run.torch.cuda.empty_cache()


def check_frames(traffic: dict, seed: int) -> list[int]:
    """The frames compared: all, or `check_frames` of them drawn from the
    seed (the first and the last always among them)."""
    n = int(traffic["frames"])
    k = int(traffic.get("check_frames", n))
    if k >= n:
        return list(range(n))
    rng = np.random.default_rng([int(seed) % (1 << 63), 11])
    pick = rng.choice(np.arange(1, n - 1), size=k - 2, replace=False)
    return sorted({0, n - 1, *map(int, pick)})


def reference_blocks(syn, traffic: dict, seed: int):
    """Yield (frame ids, float64 positions [F, N, 3]) blocks of the
    compared frames, made again from the seed."""
    import torch

    frames = check_frames(traffic, seed)
    wanted = set(frames)
    block = int(traffic.get("reference_frames", 8))
    buf = []
    for f, q in syn.grid_frames(0, frames[-1] + 1):
        if f in wanted:
            buf.append((f, q))
        if buf and (len(buf) == block or f == frames[-1]):
            p = torch.stack([syn.positions(x) for _, x in buf])
            yield [i for i, _ in buf], p
            buf = []


def compare(run: Run) -> dict:
    """{output: worst number over the kept passes and the compared frames}."""
    torch = run.torch
    from .reference.frames import Frames
    from .reference.judge import judge_block, reference_outputs

    numbers = {}
    analysis = run.traffic["analysis"]
    for ids, p in reference_blocks(run.syn, run.traffic, run.seed):
        fr = Frames(run.syn, p, torch.float64, analysis=analysis)
        want = reference_outputs(fr, analysis)
        idx = np.asarray(ids)
        for i in sorted(run.kept):
            got = {k: torch.as_tensor(np.asarray(v)[idx], device=run.device)
                   for k, v in run.kept[i].items()}
            judge_block(got, fr, analysis, numbers, want)
        del fr, p, want
    return numbers


def card_line() -> str:
    """The card's name and power limit as `nvidia-smi` reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: dict, config: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device, t_start: float, bench: dict | None = None) -> dict:
    """One run -> the result line's dict (raises BenchError where a run
    may print no result)."""
    run = Run(cell, config, traffic, seed, seconds, trace, device)
    torch = run.torch
    tmpdir = tempfile.mkdtemp(prefix="portbench-")
    # interpreter, torch and the card's driver, before the first step's span
    run.spans.add("start", t_start, time.perf_counter())
    try:
        setup(run, tmpdir)
        run.setup_s = time.perf_counter() - t_start
        window(run, tmpdir)
        if run.cuda:
            run.memory_peak = int(torch.cuda.max_memory_allocated())
        metrics = {}
        entries = (cell_metrics(bench, cell["name"], trace) if bench is not None else [])
        for m in entries:
            value = metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        free_program(run)
        t_ref = time.perf_counter()
        numbers = compare(run)
        ref_s = time.perf_counter() - t_ref
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    limits = cell.get("limits", {})
    checks, failed_names = {}, []
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not value <= limit:
            failed_names.append(name)
    correct = not failed_names and len(run.kept) > 0
    bad = forbidden_modules()
    if bad:
        raise BenchError(f"modules of JAX or the JAX package are loaded: {bad}")
    result = {
        "correct": correct,
        "attempted": len(run.passes),
        "failed": len(run.kept) if failed_names else 0,
        "metrics": metrics,
        "device": _device(run),
    }
    if trace and run.trace_info:
        result["breakdown"] = {"device_ops": run.trace_info["device_ops"],
                               "idle_gaps": run.trace_info["idle_gaps"]}
    result["checks"] = checks
    result["_reference_s"] = ref_s
    result["_run"] = run
    return result


def _device(run: Run) -> dict:
    torch = run.torch
    if run.cuda:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
               "count": 1, "memory_peak_bytes": run.memory_peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if run.trace_info:
        dev["busy_s"] = run.trace_info["busy_s"]
        dev["window_s"] = run.trace_info["window_s"]
    return dev
