"""Readings of a cell's checks over many seeds, for its program and for its
control, in one process (not part of a benchmark run).

    python3 -m benchmark.control --workload <cell> --seeds 11 12 13 ...

For each seed: the cell's set-up as a run makes it, one call of the timed
path (the call a window makes, after one untimed call in the process), its
outputs judged by the traffic's check; then the check's control (the
reference's answer with one guarantee of the configuration broken, written
in the program's formats) judged the same way.  One JSON line a seed, then
the largest program reading and the smallest control reading of each number.
The limits in benchmark/checks/ were set from these lines (PERF.md).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from .run import Runner, hold_threads
from .spec import HERE, load_cell


def readings(runner: Runner, warm: bool) -> dict:
    runner.prepare()
    if warm:
        runner.call(runner.work / "warm", runner.setup.warm_db_dir)
    c = runner.call(runner.work / "program")
    got = {"seed": runner.seed, "ok": c["ok"],
           "program": runner.check.judge(Path(c["out"]), runner.setup)}
    runner.check.control(runner.setup, runner.work / "control")
    got["control"] = runner.check.judge(runner.work / "control", runner.setup)
    return got


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = p.parse_args(argv)
    root = Path.cwd()
    cell = load_cell(a.workload, root, HERE)
    hold_threads(int(cell.config["threads"]), root)
    import torch

    torch.set_num_threads(int(cell.config["threads"]))
    if a.device == "cuda" and not torch.cuda.is_available():
        print("benchmark.control: no CUDA card", file=sys.stderr)
        return 2
    tmp = Path(os.environ["TMPDIR"]) if os.environ.get("TMPDIR") else None
    lines = []
    for i, seed in enumerate(a.seeds):
        r = Runner(cell, seed, a.device, tmp)
        try:
            lines.append(readings(r, warm=i == 0))
        finally:
            r.close()
        print(json.dumps(lines[-1]), flush=True)
    limits = lines[0]["program"].keys()
    print(json.dumps({"workload": a.workload, "seeds": len(lines),
                      "program_max": {k: max(x["program"][k] for x in lines) for k in limits},
                      "control_min": {k: min(x["control"][k] for x in lines) for k in limits},
                      "limits": dict(r.check.LIMITS)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
