"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's program object from the seed (weights on the card, rows
on the host), warms every shape the window uses (set-up), measures the
window, then checks what the timed path produced against the plain
reference (reference/) and prints one JSON line last: with --trace 0 the
cell's end-to-end metrics, with --trace 1 its per-layer metrics, read from
a torch.profiler trace of the window. Exits non-zero without a result when
no card is present, when fewer cards are present than the cell asks for,
or when a JAX module was loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpu_bench.harness import env  # noqa: E402

env.prepare()


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def end_to_end(cell, loop, res, setup_s: float):
    """The cell's end-to-end metrics from the window (host clock)."""
    values = {"setup_s": setup_s}
    if loop.kind == "eval":
        values["eval_instances_per_s"] = res.attempted / res.seconds
    elif loop.kind == "train":
        values["train_samples_per_s"] = res.attempted / res.seconds
    else:
        values["serve_p95_ms"] = percentile(res.latencies_s, 95) * 1e3
    out = {}
    for m in cell.end_to_end:
        if m["name"] not in values:
            raise KeyError(f"{cell.name}: no value for end-to-end metric {m['name']}")
        out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def per_layer(cell, ctx):
    """The per-layer metrics that the cell's readers find something to read."""
    import importlib.util

    from gpu_bench.harness.spec import reader_path

    out = {}
    for m in cell.per_layer:
        path = reader_path(m["name"])
        spec = importlib.util.spec_from_file_location(f"gpu_bench_metric_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(m["name"], ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


class Context:
    """What a per-layer reader reads: the cell, the loop and its window, the
    trace of the window, the work of the window's units and the peaks."""

    def __init__(self, cell, loop, res, trace, work, peak_flops):
        self.cell, self.loop, self.result, self.trace = cell, loop, res, trace
        self.work, self.peak_flops = work, peak_flops


def window_work(cell, loop, res, device):
    """FLOPs and hand-kernel bound seconds of the window's units, counted
    from their inputs (counts/work.py); each distinct batch counted once
    and multiplied."""
    import torch

    from gpu_bench.counts.work import batch_work

    if loop.kind == "serve":
        return None
    branches = ("inp",) if loop.kind == "eval" else ("inp", "tmp")
    total = {"flops": 0.0, "kernel_bound_s": 0.0}
    seen = {}
    for b in res.work:
        key = id(b)
        if key not in seen:
            tb = {k: ({kk: torch.as_tensor(vv, device=device) for kk, vv in v.items()}
                      if isinstance(v, dict) else torch.as_tensor(v, device=device))
                  for k, v in b.items()}
            seen[key] = batch_work(tb, cell.config["model"], branches, loop.kind == "train")
        for k in total:
            total[k] += seen[key][k]
    return total


def result_line(correct, attempted, failed, metrics, device, breakdown, checks):
    """The result's JSON object; the numbers compared, each with its limit,
    come last."""
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line


def run(args) -> int:
    import torch

    from gpu_bench.counts.peaks import PEAK_BYTES, PEAKS
    from gpu_bench.harness import check, trace as trace_mod
    from gpu_bench.harness.loops import make_loop, profiled, span
    from gpu_bench.harness.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card and has no CPU fallback")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} cards; {torch.cuda.device_count()} present")
        return 2
    if cell.chips != 1:
        log(f"{cell.name}: {cell.chips} cards are not run by this harness yet")
        return 2
    device = torch.device("cuda", 0)
    torch.set_num_threads(4)
    dtype = cell.config["model"].get("compute_dtype", "float32")
    log(f"card: {env.power_limit()}; peaks: {PEAKS[dtype]:.4g} FLOP/s ({dtype}), "
        f"{PEAK_BYTES:.4g} B/s")

    loop = make_loop(cell, args.seed, device)
    loop.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - PROCESS_START
    log(f"{cell.name}: set-up {setup_s:.3f} s")

    prof_ctx = profiled(bool(args.trace), device)
    with prof_ctx as prof:
        with span("window"):
            res = loop.window(float(args.seconds))
    log(f"{cell.name}: {res.units} units, {res.attempted} instances in {res.seconds:.3f} s")
    device_rec = env.device_record(torch, cell.chips)

    trace = None
    if args.trace:
        trace = trace_mod.from_profiler(prof)
        del prof
        device_rec["busy_s"] = trace.busy_s()
        device_rec["window_s"] = trace.window_s

    outputs = loop.program_outputs()
    torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.compare(loop, outputs, device)
    correct = check.judge(numbers, cell.limits)
    log(f"{cell.name}: reference check {time.perf_counter() - t_check:.3f} s")

    if args.trace:
        work = window_work(cell, loop, res, device)
        ctx = Context(cell, loop, res, trace, work, PEAKS[dtype])
        metrics = per_layer(cell, ctx)
    else:
        metrics = end_to_end(cell, loop, res, setup_s)

    found = env.forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return 3
    checks = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in numbers.items()}
    result = result_line(correct, res.attempted, res.failed, metrics, device_rec,
                         None if trace is None else trace_mod.breakdown(trace), checks)
    if loop.kind == "serve":
        lat = [x * 1e3 for x in res.latencies_s]
        log(f"frames {len(lat)}, p50 {statistics.median(lat):.3f} ms, "
            f"p95 {percentile(lat, 95):.3f} ms, max {max(lat):.3f} ms")
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return run(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
