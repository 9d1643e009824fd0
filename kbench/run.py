"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 kbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (and ``breakdown``).  The run needs a
CUDA card; without one, or with fewer cards than the cell asks for, it
exits with code 2 and prints no result.  It exits with code 3 and prints no
result if JAX or the JAX package was loaded.  The numbers compared with the
plain reference are printed beside their limits as the last lines of
standard error and under "compared" at the end of the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--precision", default=None,
                    help="run the program in this PRECISION mode (the control); "
                         "the benchmark's runs leave it unset")
    args = ap.parse_args(argv)

    from kbench import harness
    harness.log("torch imported at %.3f s" % (time.perf_counter() - T_START))
    harness.cache_env(ROOT)
    import torch
    chips = harness.Cell(ROOT, args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log("needs %d CUDA card(s), found %d" % (
            chips, torch.cuda.device_count() if torch.cuda.is_available() else 0))
        return 2
    result, compared = harness.run_cell(args.workload, args.seed, args.seconds,
                                        bool(args.trace), T_START, precision=args.precision)
    harness.log("card: %s; peaks used: %s" % (harness.card(), json.dumps(
        harness.yardstick.PEAKS)))
    bad = harness.forbidden_modules()
    if bad:
        harness.log("loaded modules of JAX or the JAX package: %s" % ", ".join(bad))
        return 3
    for n, v, limit in compared:
        print("compared %s %r limit %r" % (n, v, limit), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
