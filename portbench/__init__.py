"""Benchmark of the PyTorch/CUDA HEVC encoder (kvazaar_tpu_torch).

One command runs one cell of BENCHMARK.json once:

    python3 -m portbench.run --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Everything that belongs to one configuration, traffic mix, metric or
kernel sits in a file of its own that the harness finds by name:
configs/<config>.json, traffic/<mix>.json (with its generator beside it),
metrics/<metric>.py, rooflines/<kernel>.py and limits/<cell>.json. The
plain reference that decides `correct` is reference/, a frozen copy of the
port's validation decoder that imports nothing of the program.
"""
