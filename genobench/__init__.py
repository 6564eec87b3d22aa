"""genobench: the benchmark of ``miraculix_tpu_torch`` on one CUDA card.
``python3 genobench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once."""
