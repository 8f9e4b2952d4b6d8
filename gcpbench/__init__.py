"""Benchmark of the PyTorch port `video_gcp_torch` on NVIDIA GPUs.

`python -m gcpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once and prints one JSON line. Every piece of
a cell is found by its name: `configs/<config>.json`, `traffic/<mix>.json`,
`loops/<kind>.py` (the mix's `kind`), `limits/<cell>.json` and
`metrics/<metric>.py`. `reference/` is the plain PyTorch reference that
decides `correct`; it imports nothing of the program.
"""
