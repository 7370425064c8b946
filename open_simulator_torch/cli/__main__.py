"""`python -m open_simulator_torch.cli` runs the port's CLI (cli/main.py)."""

import sys

from .main import main

sys.exit(main(sys.argv[1:]))
