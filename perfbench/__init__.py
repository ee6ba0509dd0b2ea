"""The benchmark of the PyTorch / CUDA port: cells found by name.

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once; ``BENCHMARK.json`` at the checkout's
root lists the cells, configurations and metrics.
"""
