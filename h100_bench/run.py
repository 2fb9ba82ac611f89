"""Run one cell of BENCHMARK.json on this machine's cards.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (JSON); the compared
numbers and their limits are the last lines of standard error.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100_bench.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
