"""``python -m repro_torch.bench``: see :mod:`repro_torch.bench.run`."""
from .run import main

if __name__ == "__main__":
    main()
