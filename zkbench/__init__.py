"""The benchmark of the PyTorch/CUDA port (``scalable_collaborative_zksnark_tpu_torch``).

``python3 -m zkbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once (``run.py``); ``BENCHMARK.json`` at the checkout's root
names the cells, configurations and metrics, and ``manifest.py`` finds the
files of each by name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py``, the program's adapter ``adapters/<adapter>.py`` and
the plain reference ``reference/<reference>.py``.  ``control.py`` reads the
comparison's control at a cell's own size; ``tests/`` holds the benchmark's
own tests (``python -m pytest zkbench/tests``; ``-m gpu`` on a card).
"""
