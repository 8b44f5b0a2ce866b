"""rpexbench: the benchmark of the PyTorch and CUDA port of RPEX.

One command runs one cell once (``python3 rpexbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>``); ``BENCHMARK.json`` at
the root of the checkout names the cells, and each configuration, traffic
mix, limit set and metric lives in a file of its own under this folder,
found by its name.
"""
