"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (`setup_s`, from the start of this
process): the sample from the seed, the database (in the configuration's
`db_format`, emu-1 where it names none, written by
benchmark/databases/<format>.py) and the ASV directory (the
sample's templates, each with its read count as its depth) where the
traffic needs them, and one untimed whole call of the cell's traffic, which
builds or loads the kernels (build/ in the checkout), loads the native
libraries and, for classify, writes the minimizer table's cache beside the
database.  A traffic with `warm_db_refs` makes that call against a database
of that many references of its own (sintax keeps nothing from a call but
what any database warms, so the full one would only repeat a call's work).  Then the window: whole calls of `savont_tpu_torch.cli.main` with
`--device cuda` and `-t <threads>` back to back while the elapsed time is
under --seconds, each into a directory of its own and each without the
program's per-input memos (the traffic's `fresh`: a user's next sample is a
new file in a new process).  After the window the
peak device memory is read and every call's outputs are judged by the
traffic's check (benchmark/checks/).  With --trace 1 the window runs under
torch.profiler and the result carries the per-layer metrics, the device's
busy time and a breakdown; with --trace 0 the end-to-end metrics.

The last line of standard output is the result; an earlier line (`"run"`)
gives the device, the CPUs of the affinity mask, the threads, the calls and
reads of the window, and each call's wall, its process's user and system
CPU seconds, minor page faults and involuntary context switches and the
host's steal seconds (`call_host`), with a fixed
host probe's time before and after the window (`host_probe`); the last lines of standard error
are the numbers compared, each beside its limit.  No result is printed, and
the exit code is not 0, without enough CUDA cards, or when a module of jax,
jaxlib, flax or savont_tpu was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import resource  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

from .spec import HERE, Cell, forbidden_modules, load_cell, load_module  # noqa: E402

THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def hold_threads(n: int, root: Path) -> None:
    """Before torch, numpy or the port is imported: OpenMP's and the BLAS
    libraries' threads to n, and the caches of CUDA's JIT and Triton at fixed
    paths inside the checkout."""
    for v in THREAD_VARS:
        os.environ[v] = str(n)
    os.environ["CUDA_CACHE_PATH"] = str(root / "build" / "benchmark" / "cuda_cache")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "benchmark" / "triton")


@dataclass
class Setup:
    work: Path
    sample: object = None
    db_format: object = None  # databases/<format>.py: its writer (build) and plain reader (read)
    db_dir: Path | None = None
    warm_db_dir: Path | None = None  # the untimed call's database, where the traffic has its own
    asv_dir: Path | None = None
    taxa_reference: object = None


@dataclass
class Record:
    """What the per-layer readers read."""
    calls: list
    window_s: float
    trace: object = None


def _resolve(ref: str):
    """"package.module:attr" -> (module, attr name)."""
    import importlib

    mod, attr = ref.split(":")
    return importlib.import_module(mod), attr


def _reset(counters: dict) -> None:
    for ref in counters.values():
        mod, attr = _resolve(ref)
        d = getattr(mod, attr)
        for k, v in d.items():
            if isinstance(v, (int, float)):
                d[k] = type(v)(0)


def _read(counters: dict) -> dict:
    out = {}
    for name, ref in counters.items():
        mod, attr = _resolve(ref)
        out[name] = {k: v for k, v in getattr(mod, attr).items() if isinstance(v, (int, float))}
    return out


class Spans:
    """record_function spans around the program's functions that the traffic
    names (`spans`), and a span a stage from its stage clock (`stage_marks`:
    a function called with the stage that starts, or None), while tracing."""

    def __init__(self, traffic: dict):
        self.traffic, self.saved, self.open = traffic, [], None

    def __enter__(self):
        from torch.profiler import record_function

        def wrap_span(fn, name):
            def inner(*a, **k):
                with record_function(name):
                    return fn(*a, **k)
            return inner

        def wrap_mark(fn, prefix):
            def inner(stage):
                if self.open is not None:
                    self.open.__exit__(None, None, None)
                    self.open = None
                if stage is not None:
                    self.open = record_function(f"{prefix}{stage}")
                    self.open.__enter__()
                return fn(stage)
            return inner

        for table, wrap in ((self.traffic.get("spans", {}), wrap_span),
                            (self.traffic.get("stage_marks", {}), wrap_mark)):
            for ref, name in table.items():
                mod, attr = _resolve(ref)
                fn = getattr(mod, attr)
                self.saved.append((mod, attr, fn))
                setattr(mod, attr, wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)
        if self.open is not None:
            self.open.__exit__(None, None, None)
        return False


def _fresh(refs: list) -> None:
    """The program's per-input memos back to their state at import: a dict,
    list or set emptied, a number set to 0, anything else to None."""
    for ref in refs:
        mod, attr = _resolve(ref)
        v = getattr(mod, attr)
        if isinstance(v, (dict, list, set)):
            v.clear()
        else:
            setattr(mod, attr, type(v)(0) if isinstance(v, (int, float)) else None)


def _steal_s() -> float | None:
    """The host's steal time so far (all CPUs, /proc/stat), or None."""
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        return int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return None


def _host() -> dict:
    """This process's (and its waited-for children's) user and system CPU
    seconds, minor page faults and involuntary context switches, and the
    host's steal seconds, so far."""
    me, kids = resource.getrusage(resource.RUSAGE_SELF), resource.getrusage(resource.RUSAGE_CHILDREN)
    return {"user_s": me.ru_utime + kids.ru_utime, "sys_s": me.ru_stime + kids.ru_stime,
            "minflt": me.ru_minflt + kids.ru_minflt, "ivcs": me.ru_nivcsw, "steal_s": _steal_s()}


HOST_KEYS = ("user_s", "sys_s", "minflt", "ivcs", "steal_s")


def host_probe() -> float:
    """Seconds of a fixed piece of host work (Python arithmetic and a numpy
    sort, one thread), the best of three: the host's speed at this moment,
    read outside the window, beside the calls' walls and CPU seconds."""
    import numpy as np

    x = np.random.default_rng(0).integers(0, 2**62, 1 << 20)
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        sum(i * i for i in range(300_000))
        np.sort(x)
        best = min(best, time.perf_counter() - t)
    return best


class Runner:
    def __init__(self, cell: Cell, seed: int, device: str = "cuda", tmp: Path | None = None):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.traffic = cell.config, cell.traffic
        self.threads = int(self.cfg["threads"])
        self.work = Path(tempfile.mkdtemp(prefix="bench-", dir=tmp))
        self.setup = Setup(self.work)
        self.check = __import__(f"benchmark.checks.{self.traffic['check']}",
                                fromlist=["judge"])

    # -- set-up -------------------------------------------------------------
    def argv(self, sub: str, template: list, out: Path, db_dir: Path | None = None) -> list[str]:
        # the traffic files name the database directory `{emu_dir}`, whatever its format
        fill = {"reads": str(self.setup.sample.fastq), "out": str(out),
                "asv_dir": str(self.setup.asv_dir), "emu_dir": str(db_dir or self.setup.db_dir)}
        return (["--log-level", "warn"] + [a.format(**fill) for a in template]
                + ["-t", str(self.threads), "--device", self.device]
                + list(self.cfg.get("args", {}).get(sub, [])))

    def cli(self, argv: list[str]) -> int:
        from savont_tpu_torch import cli

        return cli.main(argv)

    def prepare(self) -> None:
        """The inputs, made from the seed."""
        from .sample import make_sample, rng_for, write_asv_dir

        s = self.setup
        s.sample = make_sample(self.cfg, self.seed, self.work / "sample")
        needs = self.traffic.get("needs", [])
        if "database" in needs:
            s.db_format = load_module("databases", self.cfg.get("db_format", "emu-1"))
            s.db_dir = s.db_format.build(s.sample, int(self.cfg["db_refs"]), rng_for(self.seed, 1),
                                         self.work / "db")
            if "warm_db_refs" in self.traffic:
                s.warm_db_dir = s.db_format.build(s.sample, int(self.traffic["warm_db_refs"]),
                                                  rng_for(self.seed, 2), self.work / "warm_db")
        if "asv_dir" in needs:
            s.asv_dir = write_asv_dir(s.sample, self.work / "asv")

    def call(self, out: Path, db_dir: Path | None = None) -> dict:
        counters = self.traffic.get("counters", {})
        _reset(counters)
        _fresh(self.traffic.get("fresh", []))
        sub = self.traffic["argv"][0]
        host = _host()
        try:
            rc = self.cli(self.argv(sub, self.traffic["argv"], out, db_dir))
        except Exception:  # noqa: BLE001 - a call that raises is a failed call; the run goes on
            traceback.print_exc()
            rc = -1
        after = _host()
        host = {k: None if host[k] is None or after[k] is None else after[k] - host[k] for k in HOST_KEYS}
        work = len(self.setup.sample.read_names) if self.traffic["work"] == "reads" else 1
        return {"ok": rc == 0, "rc": rc, "work": work if rc == 0 else 0, "out": str(out),
                "counters": _read(counters), "host": host}

    # -- the run ------------------------------------------------------------
    def run(self, seconds: float, trace: bool, on_card: bool = True) -> dict:
        from .window import closed_loop, end_to_end

        torch = __import__("torch")
        torch.set_num_threads(self.threads)
        if self.setup.sample is None:
            self.prepare()
        t_warm = time.perf_counter()
        warm = self.call(self.work / "warm", self.setup.warm_db_dir)
        warm["wall_s"] = time.perf_counter() - t_warm
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - T0
        probe_before = host_probe()

        def one(i):
            if trace:
                from torch.profiler import record_function

                with record_function(f"bench:{self.cell.traffic_name} call"):
                    return self.call(self.work / f"call{i}")
            return self.call(self.work / f"call{i}")

        summary = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            with Spans(self.traffic), profile(activities=acts) as prof:
                calls, window_s = closed_loop(one, seconds)
            path = self.work / "trace.json"
            prof.export_chrome_trace(str(path))
            del prof
            from .trace import read_trace

            summary = read_trace(path)
            self.trace_bytes = path.stat().st_size
            path.unlink()
        else:
            calls, window_s = closed_loop(one, seconds)
        device = {"platform": "gpu" if on_card else "cpu", "count": self.cell.chips}
        if on_card:
            torch.cuda.synchronize()
            device["kind"] = torch.cuda.get_device_name(0)
            device["memory_peak_bytes"] = int(max(torch.cuda.max_memory_allocated(i)
                                                  for i in range(self.cell.chips)))
            torch.cuda.empty_cache()
        else:
            device["kind"], device["memory_peak_bytes"] = "cpu", 0
        if summary is not None:
            device["busy_s"], device["window_s"] = summary.busy_s, summary.window_s

        probe_after = host_probe()
        # every call's outputs, by the traffic's check; the untimed call's too
        # where it ran against the cell's own database
        t_judge = time.perf_counter()
        checks = {}
        for c in ([warm] if self.setup.warm_db_dir is None else []) + calls:
            for k, v in self.check.judge(Path(c["out"]), self.setup).items():
                if k not in checks or v > checks[k][0]:
                    checks[k] = (v, self.check.LIMITS[k])
        judge_s = time.perf_counter() - t_judge
        failed = sum(1 for c in calls if not c["ok"]) + (0 if warm["ok"] else 1)
        correct = bool(calls) and failed == 0 and all(v <= lim for v, lim in checks.values())

        metrics = {}
        if trace:
            record = Record(calls, window_s, summary)
            for m in self.cell.per_layer:
                v = load_module("metrics", m["name"]).read(record)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            for m in self.cell.end_to_end:
                if m["name"] == "setup_s":
                    v = setup_s
                else:
                    v = end_to_end(self.traffic["reports"][m["name"]], calls, window_s)
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result = {"correct": correct, "attempted": len(calls), "failed": failed,
                  "metrics": metrics, "device": device}
        if summary is not None:
            result["breakdown"] = {"device_ops": summary.top(summary.op_s),
                                   "idle_gaps": summary.top(summary.gap_s)}
        result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
        self.run_line = {
            "device": device["kind"], "cpus": len(os.sched_getaffinity(0)),
            "host_probe_s": [probe_before, probe_after],
            "threads": self.threads, "torch_threads": torch.get_num_threads(),
            "calls": len(calls), "reads": sum(c["work"] for c in calls) if self.traffic["work"] == "reads" else None,
            "window_s": window_s, "setup_s": setup_s, "warm_call_s": warm["wall_s"],
            "call_walls_s": [c["wall_s"] for c in calls], "failed_rc": [c["rc"] for c in calls if not c["ok"]],
            "call_host": {k: [c["host"][k] for c in calls] for k in HOST_KEYS}, "trace_bytes": getattr(self, "trace_bytes", None),
            "judge_s": judge_s,
            "call_counters": [c["counters"] for c in calls],
        }
        return result

    def close(self) -> None:
        shutil.rmtree(self.work, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    a = p.parse_args(argv)
    root = Path.cwd()
    cell = load_cell(a.workload, root, HERE)
    hold_threads(int(cell.config["threads"]), root)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {a.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    runner = Runner(cell, a.seed, "cuda", Path(os.environ["TMPDIR"]) if os.environ.get("TMPDIR") else None)
    try:
        result = runner.run(a.seconds, bool(a.trace))
    finally:
        runner.close()
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"benchmark: the run loaded {bad}; nothing it runs may import jax, jaxlib, flax "
              "or savont_tpu", file=sys.stderr)
        return 3
    print(json.dumps({"run": runner.run_line}), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
