#!/usr/bin/env python
"""Convenience launcher for the PSA GUI (parity with the reference's
root-level psa_gui_launcher.py). Equivalent to the `psa-gui` console script."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from psa_tpu.gui.app import main

if __name__ == "__main__":
    main()
