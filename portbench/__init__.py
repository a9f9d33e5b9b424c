"""portbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` serves one cell of ``BENCHMARK.json`` through
``repro_torch.serving.engine.ServeEngine`` and prints one JSON line.  A
cell is data: ``configs/<config>.json``, ``mixes/<traffic>.json``,
``workloads/<cell>.json``, the plain reference a configuration names in
``reference/<name>.py`` and one reader per per-layer metric in
``metrics/<metric>.py``, each found by the name ``BENCHMARK.json`` gives
it.
"""
