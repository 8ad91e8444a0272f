"""Run one cell of BENCHMARK.json on this machine's CUDA card:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of the repository. The last line of standard output is the
result as one JSON object; the numbers that decided `correct` end standard
error. Exits non-zero, printing no result, without enough CUDA cards."""

import os
import time


def _process_age_s() -> float:
    """Seconds since this process was created (0 where /proc says nothing)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age_s()

if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from benchmark.harness import main

    sys.exit(main(t_start=T_START))
