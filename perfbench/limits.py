"""Readings that the limits of a cell's check are set from; not run by the
benchmark's own runs.

    python3 perfbench/limits.py --workload <cell> --seeds 1-12 [--control-seeds 1-3] [--faults]

In one process, at the cell's own sizes, for each seed: the program's first
steps (a job's set-up, no window), then the f32 reference, and their numbers
(``harness.check``): the lower readings. For each control seed: the
reference computed in the precision below the configuration's
(``precision.control``) put in the program's place, and with ``--faults``
the reference on half of each batch's rows: the upper readings. A state
left unchanged reads 1 by construction and needs no run. One JSON line a
reading on standard output and in ``--out``.
"""
import argparse
import json
import sys
import time

import boot  # noqa: F401


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import torch

    from harness import check, spec as specs
    from harness.job import Job
    from reference import train as ref

    spec = specs.load(args.workload)
    n, ls = spec["traffic_data"]["checked_steps"], spec.get("loss_steps")
    out = open(args.out, "a") if args.out else None

    def emit(**rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    refs = {}

    def reference(seed, layout, device):
        if seed not in refs:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            t0 = time.perf_counter()
            refs[seed] = ref.follow(spec, seed, layout, n, device)
            emit(seed=seed, kind="reference_s", seconds=time.perf_counter() - t0)
        return refs[seed]

    layout = None
    for seed in seeds(args.seeds) if args.seeds else []:
        job = Job(spec, seed, args.device)
        layout, device = job.layout, job.device
        readout = job.setup()
        peak = job.peak_bytes()
        job.free()
        del job
        emit(seed=seed, kind="program", numbers=check.numbers(readout, reference(seed, layout, device), ls, True),
             peak_bytes=peak)
        refs.pop(seed)
    for seed in seeds(args.control_seeds) if args.control_seeds else []:
        if layout is None:
            job = Job(spec, seed, args.device)
            layout, device = job.layout, job.device
            job.free()
            del job
        base = reference(seed, layout, device)
        low = spec["config_data"]["precision"]["control"]
        emit(seed=seed, kind=f"control_{low}", numbers=check.numbers(ref.follow(spec, seed, layout, n, device, low),
                                                                     base, ls, True))
        if args.faults and spec["traffic_data"]["batch"] > 1:
            emit(seed=seed, kind="half_batch",
                 numbers=check.numbers(ref.follow(spec, seed, layout, n, device, half_batch=True), base, ls, True))
        refs.pop(seed)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
