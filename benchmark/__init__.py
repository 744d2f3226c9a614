"""The benchmark of savont_tpu_torch: one cell run once by
`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`.

Everything it measures is found by name from BENCHMARK.json: a configuration
is `configs/<config>.json`, the format of its database (its `db_format`, the
port registry's keyword, emu-1 where it names none) `databases/<format>.py`, a
traffic mix `traffic/<traffic>.json`, a check of the outputs
`checks/<check>.py` and a per-layer metric `metrics/<metric>.py`.
Importing this package imports neither torch nor the port.
"""
