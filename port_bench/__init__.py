"""The benchmark of the PyTorch/CUDA port (``..._tpu_torch``) on one card.

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell needs is found by name: its configuration
in ``configs/``, its traffic in ``traffic/`` (read by a generator in
``gen/``), its model's driver in ``drivers/`` and plain reference in
``reference/``, the check's limits in ``limits/<cell>.json``, each
metric's reader in ``metrics/`` and each kernel family's trace names in
``kernels/``.
"""
