"""Launchers: ``python -m repro_torch.launch.serve`` (LM serving under
traffic) and ``python -m repro_torch.launch.train`` (training with
checkpoint / restart), on the card; ``steps`` holds their step functions
and ``cells`` the (architecture x input shape) grid.  The reference's
other launchers wait for ROADMAP Queue 1 items 13.3 (``mesh``) and 14.2
(``dryrun``, ``report``)."""
