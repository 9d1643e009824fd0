"""The readings a cell's limit is set from, in one process on the card:
the program on a dozen seeds or more (the lower reading: the largest
``max_rel_err`` of sound runs) and the control, the program in the next
precision below the configuration's (PRECISION='default': TF32 in the
Block-ELL kernels, cuBLAS and cuDNN; the upper reading: the smallest it
gives), each a measured window at the cell's own load compared with the
plain reference after the program is freed.  The benchmark's own runs do
not run it.

    python3 kbench/readings.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 10 [--out FILE]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings(name, seeds, control_seeds, seconds, control="default", root=ROOT,
             device="cuda", cache_dir=None):
    """{"program": {seed: reading}, "control": {seed: reading}}, a reading
    being {"max_rel_err", "requests", "spread"}."""
    from kbench import harness
    cell = harness.Cell(root, name)
    served, _ = harness.serve(cell, device, cache_dir)
    G = served.kt.globals.GLOBAL
    runs = [("program", s, cell.cfg["precision"]) for s in seeds] + \
           [("control", s, control) for s in control_seeds]
    kept = []
    for side, seed, mode in runs:
        G["PRECISION"] = cell.cfg["precision"]
        plain, pool = served.pool(seed)
        G["PRECISION"] = mode
        served.warm(pool)
        t = time.perf_counter()
        outs, reqs = served.window(pool, seconds)
        harness.log("%s seed %d (%s): %d requests in %.1f s"
                    % (side, seed, mode, len(reqs), time.perf_counter() - t))
        kept.append((side, seed, plain, outs, reqs))
    G["PRECISION"] = cell.cfg["precision"]
    served.close()
    res = {"program": {}, "control": {}}
    for side, seed, plain, outs, reqs in kept:
        refs = harness.reference_outputs(cell, plain, device)
        worst, _ = harness.compare(outs, reqs, refs, float("inf"))
        res[side][seed] = {"max_rel_err": worst, "requests": len(reqs),
                           "spread": harness.spread(refs)}
        harness.log("%s seed %d: max_rel_err %r over %d requests (outputs' spread %.6g)"
                    % (side, seed, worst, len(reqs), res[side][seed]["spread"]))
    lo = max(r["max_rel_err"] for r in res["program"].values()) if seeds else None
    hi = min(r["max_rel_err"] for r in res["control"].values()) if control_seeds else None
    res["lower"], res["upper"] = lo, hi
    harness.log("lower reading %r (largest of %d seeds), upper reading %r (smallest "
                "of %d control seeds)" % (lo, len(seeds), hi, len(control_seeds)))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from kbench import harness
    harness.cache_env(ROOT)
    harness.log("card: %s" % harness.card())
    ints = lambda s: [int(v) for v in s.split(",") if v]  # noqa: E731
    res = readings(args.workload, ints(args.seeds), ints(args.control_seeds), args.seconds)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({k: res[k] for k in ("lower", "upper")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
