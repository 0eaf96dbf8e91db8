"""Read the numbers that decide ``correct`` over many seeds in one
process: the program's (the lower readings of the cell's limits) and,
with ``--control 1``, the lower-precision reference's in the program's
place (the upper readings).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 0] [--control 1] [--out <file.jsonl>]

Each seed sets up the cell as a run does, serves its window (``--seconds
0``: one wave, the load a run judges), and judges a window wave. One
JSON line a seed, then the largest program reading and the smallest
control reading of each number.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from harness import cells
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = cells.cell(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        line, checks, numbers = cell.driver.run(
            cell, seed, args.seconds, False, t, control=bool(args.control))
        row = {"seed": seed, "correct": line["correct"], **numbers,
               "seconds": time.time() - t}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    keys = [k for k, v in rows[0].items() if isinstance(v, (int, float))
            and k not in ("seed", "correct", "seconds")]
    summary = {f"max_{k}": max(r[k] for r in rows) for k in keys
               if not k.startswith("control_")}
    summary.update({f"min_{k}": min(r[k] for r in rows) for k in keys
                    if k.startswith("control_")})
    print(json.dumps({"summary": summary, "seeds": len(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
