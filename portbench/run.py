"""Run one cell of ``BENCHMARK.json`` once on the card(s) of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell's traffic file names its path
driver (``drivers/<driver>.py``), which sets up the program from the
seed, measures for at least ``--seconds``, and has the plain reference
judge what the window served. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics and the device's
busy time under the profiler. The last line of standard output is the
result (JSON); the numbers compared with their limits are the last lines
of standard error and the result's last key. Without a card, with fewer
cards than the cell asks for, without the program (``src/``) beside this
directory, or with JAX loaded once the window has closed, the run exits
non-zero and prints no result.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import cells, result
    cell = cells.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if not (BENCH.parent / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not beside the benchmark",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    line, checks, _ = cell.driver.run(cell, args.seed, args.seconds,
                                      bool(args.trace), T0)
    bad = result.forbidden_modules()
    if bad:
        print(f"the process holds {bad} after the window", file=sys.stderr)
        return 3
    result.emit(line, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
