"""The benchmark of ``ndt_tpu_torch``, the PyTorch and CUDA renderer.

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line.  Everything a cell is made of is data found by name:
a configuration's file in ``configs/`` names its scene generator in
``scenes/``, a traffic mix is a file in ``traffic/``, a cell's compared
numbers (``harness.CHECKS``) with their limits and its control
(``control.py``) are ``cells/<cell>.json``, and each per-layer metric is
a reader of its own in ``metrics/``.  ``reference/`` is the plain
renderer that decides ``correct``; it imports nothing of the program.
"""
