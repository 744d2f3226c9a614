"""The port's spans (savont_tpu_torch/tracing.py) on the CPU: the parts of
stages 1, 4, 4p and 7 after a small `asv` on the default device routes and
of sintax's extraction, how they add up, where they sit in a profiler trace
and what the benchmark's readers make of them; and that with the profiler
off the helper opens no record_function.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tracing.py -q
"""
import json

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import run as bench_run
from benchmark import spec
from benchmark.sample import make_sample
from benchmark.trace import summarize
from savont_tpu_torch import cli, tracing
from savont_tpu_torch.config import SintaxArgs
from savont_tpu_torch.db import registry
from savont_tpu_torch.pipeline import asv as port_asv
from savont_tpu_torch.pipeline import sintax as port_sintax

from _torch_jobs import (
    clear_caches, graded_refs, rand_seq, substitute, write_asv_dir, write_emu_db,
)

PARTS = {
    "1": ("feed_wait", "count", "twin"),
    "4": ("plan", "dp", "map", "vote"),
    "4p": ("plan", "upload", "launch", "fetch", "analyze"),
    "7": ("candidates", "plan", "upload", "launch", "em", "fetch"),
}
KEYS = [f"{s}.{p}" for s, parts in PARTS.items() for p in parts]
UNREAD = ("4p.analyze", "7.candidates")  # parts no benchmark metric reads
SAMPLE = {"n_reads": 60, "n_templates": 2, "template_len": 1450, "variant_snps": [4, 6],
          "substitution_rate": 0.015, "insertion_rate": 0.0,
          "deletions": [[0.30, 1, 2], [0.10, 2, 6], [0.02, 50, 50]]}
ASV_TRAFFIC = json.loads((spec.HERE / "traffic" / "asv.json").read_text())


class CountingRecordFunction:
    """torch.profiler.record_function that counts the spans it opens."""

    opened = 0

    def __init__(self, name):
        self.rf = record_function(name)

    def __enter__(self):
        CountingRecordFunction.opened += 1
        return self.rf.__enter__()

    def __exit__(self, *exc):
        return self.rf.__exit__(*exc)


def asv(fq, out) -> dict:
    """One `asv` on the default routes; its stage clocks and parts."""
    clear_caches()
    assert cli.main(["--log-level", "warn", "asv", str(fq), "-o", str(out), "--device", "cpu",
                     "-t", "2", "--min-cluster-size", "5"]) == 0
    return dict(port_asv.STAGE_SECONDS)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    return make_sample(SAMPLE, 2**31 + 5, tmp_path_factory.mktemp("tracing") / "sample")


@pytest.fixture(scope="module")
def untraced(sample, tmp_path_factory):
    """The stage clocks of a run with the profiler off, and how many spans
    the helper opened in it."""
    CountingRecordFunction.opened = 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", CountingRecordFunction)
        stages = asv(sample.fastq, tmp_path_factory.mktemp("untraced"))
    return stages, CountingRecordFunction.opened


@pytest.fixture(scope="module")
def traced(sample, tmp_path_factory):
    """The trace events of a run under torch.profiler (CPU activity), with
    the benchmark's call span and stage spans around the program's own.
    The profiler keeps the user scope alone: on the CPU the kernels' plain
    versions run millions of operators, whose events would only bury the
    spans (a trace of more than a GB)."""
    out = tmp_path_factory.mktemp("traced")
    enable = autograd_profiler._enable_profiler

    def user_scope_only(config, activities, scopes=None):
        enable(config, activities, {torch._C._profiler.RecordScope.USER_SCOPE})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(autograd_profiler, "_enable_profiler", user_scope_only)
        with bench_run.Spans(ASV_TRAFFIC), profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("bench:asv call"):
                stages = asv(sample.fastq, out / "run")
    prof.export_chrome_trace(str(out / "trace.json"))
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    return stages, [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_every_part_of_the_table_is_timed(untraced):
    stages, _ = untraced
    assert all(stages[k] > 0 for k in KEYS), sorted(set(KEYS) - set(stages))


@pytest.mark.parametrize("stage", sorted(PARTS))
def test_parts_sum_to_no_more_than_their_stage(untraced, stage):
    stages, _ = untraced
    parts = sum(stages[f"{stage}.{p}"] for p in PARTS[stage])
    assert 0 < parts <= stages[stage]


def test_profiler_off_opens_no_span(untraced):
    """The whole run, with torch.profiler.record_function counting: the
    helper opened none, though every part was timed."""
    assert untraced[1] == 0


def test_helper_opens_a_span_only_while_recording(monkeypatch):
    CountingRecordFunction.opened = 0
    monkeypatch.setattr(torch.profiler, "record_function", CountingRecordFunction)
    into: dict = {}
    with tracing.span("t:off", into, "off"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("t:on", into, "on"), tracing.span(None, into, "timer"):
            pass
    assert CountingRecordFunction.opened == 1
    assert set(into) == {"off", "on", "timer"} and all(v >= 0 for v in into.values())


def test_part_keys_follow_the_running_stage():
    stage_s: dict = {}
    tracing.enter_stage(stage_s, "4")
    try:
        with tracing.part("dp", also=(stage_s, "dp_total")):
            pass
    finally:
        tracing.enter_stage(stage_s, None)
    with tracing.part("dp"):
        pass
    assert set(stage_s) == {"4.dp", "dp_total"} and stage_s["4.dp"] == stage_s["dp_total"]
    assert "dp" in tracing.PART_SECONDS


@pytest.mark.parametrize("stage", sorted(PARTS))
def test_part_spans_nest_in_their_stage_span(traced, stage):
    stages, spans = traced
    assert all(stages[k] > 0 for k in KEYS)
    outer = [(e["ts"], e["ts"] + e["dur"]) for e in spans if e["name"] == f"asv:stage_{stage}"]
    assert len(outer) == 1
    (a, b), = outer
    for p in PARTS[stage]:
        inner = [e for e in spans if e["name"] == f"asv:{stage}.{p}"]
        assert inner, p
        assert all(a <= e["ts"] and e["ts"] + e["dur"] <= b for e in inner), p


def test_trace_gaps_are_named_by_the_parts(traced):
    """On the CPU no device operation runs: the whole window is idle, each
    piece of it named by the innermost span; every part names some, and in
    stages 4, 4p and 7 the parts name more than the bare stage span."""
    _, spans = traced
    gaps = summarize(spans).gap_s
    assert all(gaps.get(f"asv:{k}", 0) > 0 for k in KEYS), gaps
    for stage in ("4", "4p", "7"):
        parts = sum(gaps[f"asv:{stage}.{p}"] for p in PARTS[stage])
        assert parts > gaps.get(f"asv:stage_{stage}", 0.0), (stage, gaps)


def test_sintax_parse_and_extract_make_up_the_extraction(tmp_path, monkeypatch):
    """A sintax run in chunks of 8 references, with the profiler off:
    parse_s + extract_s is kmers_s to within 5%, flush_s is timed, and no
    span was opened."""
    rng = np.random.default_rng(91)
    refs = graded_refs(91, n_bases=4)
    write_emu_db(tmp_path / "db", refs)
    asvs = [refs[0][4], bytes(substitute(rng, refs[9][4], 0.05)), rand_seq(rng, 1400)]
    in_dir = write_asv_dir(tmp_path / "run", asvs)
    monkeypatch.setattr(port_sintax, "CHUNK_ROWS", 8)
    CountingRecordFunction.opened = 0
    monkeypatch.setattr(torch.profiler, "record_function", CountingRecordFunction)
    for k in ("kmers_s", "parse_s", "extract_s", "flush_s"):
        monkeypatch.setitem(port_sintax.SCORE_STATS, k, 0.0)
    port_sintax.sintax(SintaxArgs(input_dir=str(in_dir), output_dir=str(tmp_path / "out"),
                                  db=str(tmp_path / "db"), device="cpu"),
                       registry.load_database(tmp_path / "db"))
    st = port_sintax.SCORE_STATS
    assert st["extract_s"] > 0 and st["parse_s"] > 0 and st["flush_s"] > 0
    assert st["parse_s"] + st["extract_s"] == pytest.approx(st["kmers_s"], rel=0.05)
    assert CountingRecordFunction.opened == 0


def _record(counter: str, values: dict, work: int, calls: int = 2):
    return bench_run.Record(calls=[{"ok": True, "work": work, "counters": {counter: values}}] * calls,
                            window_s=1.0)


ASV_METRICS = {f"stage{k.replace('.', '_')}_ms_per_kread": k for k in KEYS if k not in UNREAD}
SINTAX_METRICS = {f"sintax_{k}": k for k in ("parse_s", "extract_s", "flush_s")}


@pytest.mark.parametrize("name", sorted(ASV_METRICS))
def test_asv_part_reader(name):
    """Two calls of 4,000 reads, 0.25 s in the part each: 62.5 ms a kread."""
    read = spec.load_module("metrics", name).read
    key = ASV_METRICS[name]
    assert read(_record("stage_s", {key: 0.25, "4": 9.0}, 4000)) == pytest.approx(62.5)
    assert read(_record("stage_s", {"4": 9.0}, 4000)) is None  # a parent without the part


@pytest.mark.parametrize("name", sorted(SINTAX_METRICS))
def test_sintax_part_reader(name):
    read = spec.load_module("metrics", name).read
    key = SINTAX_METRICS[name]
    assert read(_record("sintax_stats", {key: 1.5, "kmers_s": 3.0}, 1, calls=3)) == pytest.approx(1.5)
    assert read(_record("sintax_stats", {"kmers_s": 3.0}, 1)) is None


def test_every_new_metric_is_declared():
    bench = json.loads((spec.HERE.parent / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in ASV_METRICS:
        assert declared[name]["workloads"] == ["operon.asv"]
        assert declared[name]["moves"] == "asv_reads_per_s"
    for name in SINTAX_METRICS:
        assert declared[name]["workloads"] == ["ont16s.sintax"]
        assert declared[name]["moves"] == "sintax_s"
