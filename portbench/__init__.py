"""The benchmark of the PyTorch and CUDA port (``mcmcdiagnostictools_jl_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything that belongs
to one configuration, traffic mix, cell or metric is a file of its own,
found by its name: ``configs/<config>.json``, ``mixes/<traffic>.json``,
``limits/<cell>.json``, ``metrics/<metric>.py``. The yardstick lives here
too: the sample generator, the plain references (``reference/``), the peaks
of the card (``peaks.json``) and the comparison that decides ``correct``. A
cell whose mix names the argument kind ``"mesh"`` runs as a world of ranks,
one process a card (``world.py``).
"""
