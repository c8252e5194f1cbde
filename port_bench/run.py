#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

Run from the root of a checkout:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Needs as many CUDA devices as the cell asks for; exits 2 with no result
otherwise.
"""
import time

_T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402


def _age() -> float:
    """Seconds since this process started (from /proc; 0 where absent)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)


_STARTED = _T0 - _age()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from port_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], started=_STARTED))
