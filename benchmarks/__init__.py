"""The benchmark of ``tpu_cnn_torch`` on one NVIDIA H100.

``python3 -m benchmarks.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line last. Everything a cell needs is found by name: its
configuration under ``configs/``, its traffic mix under ``traffic/``, the
driver the mix names under ``drivers/``, its own parameters under
``workloads/``, each per-layer metric's reader under ``metrics/``, the
plain reference and comparison the configuration names under
``reference/`` and, for a bundle drawn from a seed, its maker under
``bundles/`` (``lib/spec.py`` lists them). ``lib/`` holds the yardstick
(the traffic generator, the frozen roofline arithmetic, the trace
reduction, the window statistics and the judgement that decides
``correct``). None of it imports JAX or the JAX package, and
``reference/`` imports nothing of the program.
"""
