"""The benchmark's tests run on the CPU at tiny sizes with the program's
plain day in place of its CUDA kernel: ``python -m pytest h9bench/tests
-q`` from the root of the repository.  The test marked ``cuda`` runs a
cell on the card and skips elsewhere."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
