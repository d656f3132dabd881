"""The benchmark of the PyTorch and CUDA port ``deepfluoro_tpu_torch``:
``python3 fluorobench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout (``BENCHMARK.json`` names the
cells)."""
