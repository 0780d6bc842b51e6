"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See ``core.py`` for what a run does and
``README.md`` for how cells, configurations and metrics are added.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.core import process_start, run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(t_start=process_start()))
