"""The benchmark's command: one run of one cell, on the machine it starts
on.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output, and the numbers
that decide ``correct``, each beside its limit, as the last lines of
standard error.  Exits with 2 and prints no result where there is no card
or fewer cards than the cell asks for, and with 3 where the run loaded
JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import harness, spec

    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), cell=spec.cell(
                                      args.workload))
    except harness.NoCard as e:
        print(e, file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
