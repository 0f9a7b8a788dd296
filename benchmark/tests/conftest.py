"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
root of the repository. Tests marked `cuda` run on a card and skip without
one, deciding inside the test."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
