"""The benchmark of ``saigegds_tpu_torch`` on NVIDIA H100 cards.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; ``README.md`` says
how the cells, configurations, mixes and metrics are found."""
