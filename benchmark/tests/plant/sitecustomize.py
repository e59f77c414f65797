"""Plants the fault that ``PLANTED_FAULT`` names
(``benchmark/tests/faults.py``) in a Python process that starts with this
directory on its path."""

import os

if os.environ.get("PLANTED_FAULT"):
    from benchmark.tests import faults
    faults.FAULTS[os.environ["PLANTED_FAULT"]](faults.Planted)
