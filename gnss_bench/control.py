#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, on the card.

    python3 gnss_bench/control.py --workload <cell> --seeds 1,2,3
        [--seconds 4] [--out readings_<cell>.json]

For each seed, one run of the cell at its own sizes with a short window
(``run.run_cell``), in one process: the numbers the program's sample
reads against the reference (the lower readings), and the control's:
the reference in the program's place computed in the next precision
below the configuration's, bfloat16 (the upper readings).  The control
is held to the configuration's limits by the same decision as the
program (``run.held``): its ``correct`` has to come out false on every
seed.  Prints each seed's readings and verdicts and, per number, the
largest program reading, the smallest control reading, the limit and
their ratio; the last line says whether every control read not
correct.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from gnss_bench import run  # noqa: E402


def summary(rows: list, limits: dict) -> dict:
    """Per number: the largest program reading and the smallest control
    reading over the seeds, beside the number's limit."""
    out = {}
    for k in sorted({k for r in rows for k in r["numbers"]}):
        lo = max(r["numbers"].get(k, -math.inf) for r in rows)
        up = min(r["control"].get(k, math.inf) for r in rows)
        out[k] = dict(lower=lo, upper=up, limit=limits.get(k),
                      ratio=(up / lo if lo > 0 else math.inf))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell, cfg, traffic, _ = run.cell_spec(args.workload)
    run.checkout_caches()
    import torch
    if not torch.cuda.is_available():
        print("gnss_bench: no CUDA device", file=sys.stderr)
        return 2
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(cell, cfg, traffic, seed, args.seconds, False,
                           "cuda", controls=("bf16",))
        row = dict(seed=seed, correct=out["correct"], failed=out["failed"],
                   attempted=out["attempted"], missed=out["missed"],
                   errors=out["errors"],
                   numbers={k: float(v) for k, v in out["numbers"].items()},
                   control={k: float(v) for k, v in
                            out["control_numbers"]["bf16"].items()},
                   control_correct=out["control_correct"]["bf16"],
                   control_bad=[k for k, c in
                                out["control_checks"]["bf16"].items()
                                if not c["value"] <= c["limit"]])
        rows.append(row)
        print(json.dumps(row), flush=True)
    summ = summary(rows, cfg["limits"])
    for k, v in summ.items():
        print(f"{k}: program max {v['lower']!r}, control min "
              f"{v['upper']!r}, limit {v['limit']!r}, ratio "
              f"{v['ratio']:.3g}")
    verdict = dict(program_correct=sum(r["correct"] for r in rows),
                   control_correct=sum(r["control_correct"] for r in rows),
                   seeds=len(rows))
    print(f"program correct on {verdict['program_correct']} of "
          f"{len(rows)} seeds; control correct on "
          f"{verdict['control_correct']} of {len(rows)} (has to be 0)")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(workload=args.workload,
                           card=torch.cuda.get_device_name(0), rows=rows,
                           summary=summ, verdict=verdict), f, indent=1)
    return 0 if verdict["control_correct"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
