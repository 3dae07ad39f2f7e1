"""``python -m gpufluidsimulator_torch``: the command-line interface."""

import sys

from .utils.cli import main

if __name__ == "__main__":
    sys.exit(main())
