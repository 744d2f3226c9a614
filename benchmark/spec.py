"""BENCHMARK.json and the files it names, resolved by name.

Pure Python and json: run.py reads the cell's thread count from here before
torch, numpy or the port is imported.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict        # configs/<config>.json
    traffic_name: str
    traffic: dict       # traffic/<traffic>.json
    end_to_end: list    # BENCHMARK.json's end_to_end entries this cell reports
    per_layer: list     # its per_layer entries this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path, bench_dir: Path = HERE) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its configuration and
    traffic files read from bench_dir."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, chips=int(w["chips"]),
        config_name=w["config"], config=json.loads((root / cfg["file"]).read_text()),
        traffic_name=w["traffic"],
        traffic=json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def load_module(kind: str, name: str, bench_dir: Path = HERE):
    """benchmark/<kind>/<name>.py as a module (names may hold dots).  A
    metric split by the end-to-end metric it moves (`device_idle_pct.asv`)
    is read by the quantity's own reader (`device_idle_pct.py`) where it has
    none of its own."""
    path = bench_dir / kind / f"{name}.py"
    if not path.exists() and "." in name:
        path = bench_dir / kind / f"{name.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}", path)
    if spec is None or not path.exists():
        raise SystemExit(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FORBIDDEN = ("jax", "jaxlib", "flax", "savont_tpu")


def forbidden_modules(names) -> list[str]:
    """The loaded module names whose top-level name (before the first dot)
    is one of FORBIDDEN, compared whole: savont_tpu_torch is not savont_tpu."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
