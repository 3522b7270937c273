"""The benchmark of hgnn2_torch, the PyTorch and CUDA port, on NVIDIA H100
cards. One run measures one cell of BENCHMARK.json:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration in
configs/<config>.json, its traffic mix in traffic/<mix>.json, the limits of
its correctness check in limits/<cell>.json, each per-layer metric's reader
in metrics/<metric>.py, the driver of its kind of traffic in
drivers/<kind>.py, the port's side of its model in models/<model>.py and
the plain reference of that model in reference/<model>.py. Nothing here
imports JAX or the JAX package.
"""
