"""Launchers: ``python -m repro_torch.launch.serve`` (LM serving under
traffic, on the card).  The reference's other launchers (``train``,
``steps``, ``dryrun``, ``mesh``, ``cells``, ``report``) wait for ROADMAP
Queue 1 item 14."""
