"""The benchmark of `cloudsc_tpu_torch` on the H100: `BENCHMARK.json` at the
checkout's root names its cells; `python3 cellbench/run.py` runs one
(see run.py). Configurations, traffic mixes and metric readers are files
found by name under `configs/`, `traffic/` and `metrics/`; `reference/`
is the plain reference that decides `correct`; `work.py` the yardstick
of the roofline share."""
