"""The benchmark of ``repro_torch``: zone offloads timed end to end on one card.

``python3 zcsd_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Configurations (``configs/``), traffic mixes (``traffic/``), kinds of
deployment (``kinds/``), plain references (``reference/``) and per-layer
metric readers (``metrics/``) are files of their own, found by the names
``BENCHMARK.json`` and the configurations give (``spec.py``).
"""
