"""The benchmark of ``flox_tpu_torch`` on NVIDIA H100 cards.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Every part
that belongs to one configuration, cell, traffic mix or metric is a file of its
own, found by its name: ``configs/``, ``cells/``, ``traffic/`` and
``metrics/``. Nothing here imports ``jax`` or ``flox_tpu``; ``reference/``
imports nothing of ``flox_tpu_torch`` either.
"""
