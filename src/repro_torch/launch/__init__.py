"""Launchers: ``python -m repro_torch.launch.serve`` (LM serving under
traffic) and ``python -m repro_torch.launch.train`` (training with
checkpoint / restart, on one device or a ``data x model`` mesh of
ranks), on the card; ``steps`` holds their step functions, ``cells`` the
(architecture x input shape) grid and ``mesh`` the meshes of ranks.  The
reference's other launchers wait for ROADMAP Queue 1 item 14.2
(``dryrun``, ``report``)."""
