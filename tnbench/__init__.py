"""tnbench: the benchmark of cotengra_tpu_torch on an NVIDIA GPU.

``python tnbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` (see ``run.py``).
Everything that belongs to one configuration, traffic mix, metric or
comparison is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the network's recipe, the committed plan
  it is contracted by, the program's options, the precision and the
  comparison that decides ``correct``;
- ``traffic/<mix>.json``: the entry called, what each call takes, the
  pool of input sets, warm-up, the profiled stretch and the calls
  checked;
- ``metrics/<metric>.py``: one reader per metric, ``read(run)`` on the
  run's record (``harness.Run``), returning None where it finds nothing;
  a metric ``<name>.<split>`` with no file of its own reads with
  ``<name>``'s (``harness.metric_path``);
- ``networks/<generator>.py``, ``entries/<kind>.py``,
  ``checks/<number>.py``: the generators, the ways of calling the
  program and the compared numbers that those files name;
- ``reference/``: the plain reference, which imports nothing of the
  program.
"""
