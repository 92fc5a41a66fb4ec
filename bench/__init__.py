"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` (see ``README.md``):

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything here imports only ``torch``, ``numpy``, the standard library and,
for the system under test, ``repro_torch``; ``bench/reference`` imports not
even that.
"""
