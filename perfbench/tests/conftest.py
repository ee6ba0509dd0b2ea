"""The perfbench tests import the checkout's ``perfbench`` and the port
from ``src``; each worker keeps to one intra-op thread."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

torch.set_num_threads(1)
