"""The benchmark of the PyTorch and CUDA tracker ``playground3d_tpu_torch``.

One run of one cell (a configuration under a traffic mix, on its chips):

    python3 -m cellbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root of the checkout names the cells and the
metrics. Everything else is found by name: ``configs/<config>.json`` (the
nets, their precision, the tracker's settings), ``archs/<arch>.py`` (what
the harness needs of a net's architecture), ``traffic/<mix>.json`` (the
cameras, frames and loop) and ``metrics/<metric>.py`` (one reader a
per-layer metric). ``reference/`` holds the plain PyTorch copy of the
tracker that decides ``correct``; nothing in this package imports JAX.
"""
