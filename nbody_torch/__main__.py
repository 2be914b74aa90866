"""python -m nbody_torch: the command-line driver (nbody_torch.cli)."""

from nbody_torch.cli import main

raise SystemExit(main())
