"""Run one cell of the port's benchmark.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
Prints the compared numbers beside their limits as the last lines of
standard error and the result as one JSON line, the last of standard
output.  Exits non-zero, printing no result, where the cards are missing,
the port cannot be imported, or JAX or the JAX package is loaded once the
window has closed.

Only the standard library is imported at the top: the reference's worker
processes import this module again.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_T_IMPORT = time.perf_counter()


def process_start() -> float:
    """perf_counter() at the start of this process (read from /proc), or
    at this module's import where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError, AttributeError):
        return _T_IMPORT
    now = time.perf_counter()
    if not 0 <= age <= now - _T_IMPORT + 600:
        return _T_IMPORT
    return now - age


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()

    from . import harness
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=t_start)
    except harness.Unavailable as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: loaded in the measuring process: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
