"""The port's benchmark harness: the registry sweep that writes schema-7
``BENCH_<kernel>.json`` records (``bench_kernels``), the paper's analytic
tables (``bench_bounds``, ``bench_roofline``) and the CLI
(``python -m repro_torch.bench``, :mod:`repro_torch.bench.run`)."""
