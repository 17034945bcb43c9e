"""The tests of the benchmark, on the CPU.  Run them from the root of a checkout:

    python -m pytest portbench/tests -q

``test_portbench_chip.py`` needs a CUDA device (marked ``cuda``; it skips
without one).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
