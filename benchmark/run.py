"""One run of one cell of ``BENCHMARK.json`` on the card:

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Prints, as the last line of standard output,
the JSON result (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit), and those numbers as the last lines of
standard error. Exits non-zero without a result where there is no card,
fewer cards than the cell asks for, or a JAX module was loaded.
"""
import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# transformers and other libraries must not load JAX behind the port's back
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True, type=int)
    ap.add_argument("--seconds", required=True, type=float)
    ap.add_argument("--trace", default=0, type=int, choices=(0, 1))
    ap.add_argument("--control", choices=("bf16",), default=None,
                    help=argparse.SUPPRESS)  # the check's control, by hand
    args = ap.parse_args(argv)

    from benchmark.common import card, harness

    spec = harness.load_spec()
    cell = harness.cell_of(spec, args.workload)
    card.require_cards(cell["chips"])
    result, checks, log = harness.run_cell(
        spec, cell, args.seed, args.seconds, bool(args.trace), T_START,
        control=args.control)
    bad = card.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in log:
        print(line, file=sys.stderr)
    for k, v in checks.items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
