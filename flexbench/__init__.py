"""The benchmark of the PyTorch port (``repro_torch``): Flex studies on
one NVIDIA H100.  ``python3 flexbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once
and prints one JSON line."""
