"""The benchmark of the PyTorch and CUDA port (``repro_torch``): STEP's
analytics apps on one card, one cell a run.  ``python3 stepbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` runs a cell of
``BENCHMARK.json`` once and prints its result as the last line."""
