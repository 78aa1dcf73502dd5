"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

One run measures one cell of ``BENCHMARK.json`` (a model configuration
under a traffic mix) and prints one JSON line::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it: ``configs/<config>.json`` (with the plain
reference module it names beside it), ``traffic/<mix>.json`` and
``metrics/<metric>.py``.  Nothing here imports JAX or the JAX package.
"""
