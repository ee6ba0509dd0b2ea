"""Launchers: ``python -m repro_torch.launch.serve`` (LM serving under
traffic) and ``python -m repro_torch.launch.train`` (training with
checkpoint / restart, on one device or a ``data x model`` mesh of
ranks), on the card; ``python -m repro_torch.launch.dryrun`` (every
architecture x cell traced on meta tensors over a fake 256- or 512-rank
mesh: the roofline terms) and ``python -m repro_torch.launch.report``
(its tables), on the CPU.  ``steps`` holds the step functions, ``cells``
the (architecture x input shape) grid and ``mesh`` the meshes of
ranks."""
