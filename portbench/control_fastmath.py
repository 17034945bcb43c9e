"""``control.py`` for the 16-bit cells: the same readings, with the control
of their contract in the place of TF32.

    python3 portbench/control_fastmath.py --workload sl-fastmath-fixed-null \
        --seeds 1,2,3 --control-seeds 1,2,3 --seconds 3 --out readings.jsonl

The control is the plain reference one precision below the configuration's
(``reference/searchlight_fastmath.OutputsInBf16``: each bf16 product's output
rounded to bf16 as well), put in the program's place.  Needs a CUDA device.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import control  # noqa: E402
from portbench.reference.searchlight_fastmath import OutputsInBf16  # noqa: E402

if __name__ == "__main__":
    control.tf32 = OutputsInBf16
    sys.exit(control.main())
