"""The port's benchmark: one command runs one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``); the mix names its driver (``drivers/<driver>.py``),
each per-layer metric has its reader (``metrics/<metric>.py``) and each
cell its correctness limits (``limits/<cell>.json``).  ``yardstick/`` and
``reference/`` hold what the program may not move: the weight and token
draws, the FLOP counts, the profiler's reduction and the plain float32
reference that decides ``correct``.
"""
