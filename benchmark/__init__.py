"""The benchmark of ``moco_flow_tpu_torch`` on one H100: ``run.py`` runs a
cell of ``BENCHMARK.json``; ``cells.py`` finds its files by name;
``kinds/`` holds one module a kind of work (set-up, step, work counted,
comparison); ``scene.py`` makes the inputs from the seed; ``reference/``
is the plain reference that decides ``correct``; ``metrics/`` holds one
reader a metric; ``counts.py`` the operations and bytes."""
