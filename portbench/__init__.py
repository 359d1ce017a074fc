"""The benchmark of the PyTorch and CUDA port (``peasoup_tpu_torch``).

One run searches observations through ``PeasoupSearch.run`` on one card,
back to back, for a fixed time, and prints one JSON line. Everything a
cell needs is found by name: ``BENCHMARK.json`` names the cells, each
cell a configuration (``configs/<name>.json``: the deployment's
geometry) and a traffic mix (``traffic/<name>.json``: the search's
settings and the signals injected), and each per-layer metric is a
reader of its own (``metrics/<name>.py``). Each hand-written kernel's
operations and bytes are counted from its launch shapes in
``roofline/<kernel>.py``. ``reference/`` is the plain reference that
decides ``correct``; it imports nothing of the port.

Run one cell once::

    python3 -m portbench.run --workload htru_hilat.accel --seed 7 --seconds 10 --trace 0

Nothing here imports ``jax`` or the JAX package ``peasoup_tpu``.
"""
