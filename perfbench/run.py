"""Runs one cell of the benchmark of ``repro_torch`` once, on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell (``perfbench/workloads/<cell>.json`` and the configuration
and traffic it names), sets up its jobs, measures for ``--seconds`` and
checks the first steps against the plain reference. The last line of
standard output is one JSON object: ``correct``, ``attempted`` (steps in
the window), ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones, each read by ``perfbench/metrics/<name>.py``),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number compared beside its limit, which also close standard error.

Exits 2 without a result where no card (or fewer than the cell asks for) is
there, and 3 where JAX or the JAX package was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

import boot  # noqa: E402

def read_metric(name: str, ctx: dict):
    path = boot.HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(ctx)


def _num(x: float):
    return x if math.isfinite(x) else str(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness import cell, check, spec as specs

    spec = specs.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"{args.workload} needs {spec['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    bench = specs.benchmark()
    res = cell.run(spec, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)

    bad = sorted(set(boot.forbidden_modules()) | set(res["forbidden_modules"]))
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": spec["chips"],
              "memory_peak_bytes": res["peak_bytes"]}
    metrics = {}
    if args.trace:
        device.update(busy_s=res["trace"]["busy_s"], window_s=res["trace"]["window_s"])
        ctx = {"spec": spec, "run": res, "trace": res["trace"]}
        for m in specs.metrics_for(bench, args.workload, "per_layer"):
            value = read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {spec["rate_metric"]: res["rate"],
                  "peak_mem_gib": res["peak_bytes"] / 2**30, "setup_s": res["setup_s"]}
        for m in specs.metrics_for(bench, args.workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    print(f"setup_s {res['setup_s']!r}, steps in the window {res['steps']}, rate {res['rate']!r}, "
          f"peak_bytes {res['peak_bytes']}, reference_s {res['reference_s']!r}", file=sys.stderr)
    limits = spec["limits"]
    correct = check.verdict(res["numbers"], limits) and res["failed"] == 0
    for k in check.NUMBERS:
        print(f"check {k}: {res['numbers'][k]!r} (limit {limits[k]!r})", file=sys.stderr)
    result = {"correct": correct, "attempted": res["steps"], "failed": res["failed"], "metrics": metrics,
              "device": device}
    if args.trace:
        result["breakdown"] = res["trace"]["breakdown"]
    result["checks"] = {k: {"value": _num(v["value"]), "limit": v["limit"]}
                        for k, v in check.report(res["numbers"], limits).items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
