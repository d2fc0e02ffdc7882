"""One job of a collocated cell, as a process of its own (``harness.collocate``).

    python3 perfbench/job.py '<json: spec, seed, seconds, trace, device, start_file, record>'

Sets the job up, prints ``ready``, waits for the start file and the instant
written in it, runs its windows and its check, writes its record to
``record`` and prints ``perfbench-job`` with its steps, peak and numbers.
"""
import json
import sys
import time
from pathlib import Path

import boot


def main() -> int:
    args = json.loads(sys.argv[1])
    from harness import cell

    start_file = Path(args["start_file"])

    def gate() -> float:
        print("ready", flush=True)
        while not start_file.exists():
            time.sleep(0.005)
        return float(start_file.read_text())

    record = cell.run_job(args["spec"], args["seed"], args["seconds"], args["trace"], args["device"], gate)
    record["forbidden_modules"] = boot.forbidden_modules()
    Path(args["record"]).write_text(json.dumps(record))
    print("perfbench-job " + json.dumps({"seed": args["seed"], "steps": len(record["ends"]),
                                         "peak_bytes": record["peak_bytes"], "numbers": record["numbers"],
                                         "forbidden_modules": record["forbidden_modules"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
