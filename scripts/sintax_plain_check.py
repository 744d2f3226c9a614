"""The port's `sintax` on a benchmark cell's inputs against the plain SINTAX
(benchmark/plain_sintax.py), byte for byte.

    python3 scripts/sintax_plain_check.py --workload silva.sintax --seed N [--seed M ...]
        [--device cuda] [--threads T] [--out DIR]

For each seed: the cell's sample, database and ASV directory as the
benchmark makes them (benchmark/run.py's Runner.prepare), one call of the
cell's traffic through savont_tpu_torch.cli on --device, then the plain
reference on the same database and ASVs on T host threads; one JSON line a
seed (the two outputs equal or not, the seconds of each side, the call's
sintax counters) and exit code 1 if any output differs.  With --out, each
seed's two output directories are kept there.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import plain_sintax  # noqa: E402
from benchmark.run import Runner, hold_threads  # noqa: E402
from benchmark.spec import HERE, load_cell  # noqa: E402

OUTPUTS = ("asv_mappings.tsv", "genus_abundance.tsv")


def check(cell, seed: int, device: str, threads: int, keep: Path | None) -> dict:
    r = Runner(cell, seed, device)
    try:
        t = time.perf_counter()
        r.prepare()
        setup_s = time.perf_counter() - t
        t = time.perf_counter()
        call = r.call(r.work / "port")
        port_s = time.perf_counter() - t
        t = time.perf_counter()
        plain_sintax.sintax(r.setup.asv_dir, r.setup.db_dir, r.work / "plain", threads=threads)
        plain_s = time.perf_counter() - t
        same = {f: (r.work / "port" / f).read_bytes() == (r.work / "plain" / f).read_bytes()
                for f in OUTPUTS} if call["ok"] else {f: False for f in OUTPUTS}
        if keep is not None:
            for side in ("port", "plain"):
                shutil.copytree(r.work / side, keep / f"{cell.name}_{seed}" / side, dirs_exist_ok=True)
        return {"workload": cell.name, "seed": seed, "device": device, "ok": call["ok"],
                "equal": same, "setup_s": setup_s, "port_s": port_s, "plain_s": plain_s,
                "counters": call["counters"]}
    finally:
        r.close()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    p.add_argument("--out", type=Path)
    a = p.parse_args(argv)
    root = Path.cwd()
    cell = load_cell(a.workload, root, HERE)
    hold_threads(int(cell.config["threads"]), root)
    import torch

    torch.set_num_threads(int(cell.config["threads"]))
    bad = 0
    for seed in a.seed:
        line = check(cell, seed, a.device, a.threads, a.out)
        if a.device == "cuda":
            line["card"] = torch.cuda.get_device_name(0)
        bad += not all(line["equal"].values())
        print(json.dumps(line), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
