"""The control of a cell: its runs with the program's bfloat16 message
path switched on, on the card at the cell's own size, one run a seed.

    python3 bench/control.py --workload g500s16-pagerank --seconds 5 \\
        --seeds 101 102 103

Prints each run's comparison (the numbers and their limits) as one JSON
line.  Each number's upper reading is the smallest the control gives; the
limits in ``limits/<cell>.json`` lie below it (PERF.md has the readings).
The benchmark's own runs do not run this.
"""
import argparse
import json
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]
    import harness

    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        out = harness.run_cell(cell, seed, args.seconds, False,
                               time.perf_counter(), device="cuda",
                               overrides={"message_dtype": "bfloat16"})
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "compared": out["compared"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
