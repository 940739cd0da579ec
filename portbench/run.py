"""Run one cell of the benchmark once on this machine's CUDA device:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (``portbench/harness.py``); without a CUDA device the run fails and
prints none.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":
    from portbench.harness import main

    sys.exit(main())
