"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell once (see ``README.md``)::

    python3 portbench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration in
``configs/``, its traffic mix in ``traffic/`` (a data file naming the
general driver in ``drivers/`` that serves it), its comparison limits in
``checks/``, its plain reference in ``reference/`` and each metric's
reader in ``metrics/``.
"""
