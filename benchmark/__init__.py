"""The benchmark of ``zraytrace_tpu_torch`` on NVIDIA GPUs.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
its result as the last line of standard output. Everything a cell is made
of is data found by name: ``configs/<config>.json`` (the deployment: the
scene, its sizes and the frozen work prices), ``traffic/<mix>.json`` (what
the window sends, read by the driver its ``kind`` names),
``metrics/<metric>.py`` (one per-layer reader each) and
``limits/<cell>.json`` (the limits of the correctness check).
``reference/`` is the plain implementation the check compares with; it
imports nothing of the program.
"""
