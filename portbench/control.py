"""The control of a cell's check: the reference put in the program's place
with one guarantee broken, which the check has to call not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

The control matches each 65,536-byte piece of a document on its own and
ORs the answers: the parallel split without the speculative merge, so a
match that spans two pieces is lost.  (The program's chunks at these widths
are 64 KiB or 128 KiB, both multiples of the piece.)  For each seed
it draws the cell's input pool, answers one call of each pool input through
the control, and prints the check's numbers (the control's reading, which
sets the upper end of each limit) and, from the reference, the share of the
pool's documents in which each pattern occurs.  Needs no card; the benchmark's own runs
never run it.
"""

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def readings(name: str, seeds, *, split: int = 65536, mix=None,
             workers: int = 0) -> list[dict]:
    """The check's numbers for the control, one dict a seed."""
    from portbench import harness, manifest
    from portbench.reference import membership

    cell = manifest.resolve(name)
    if mix is not None:
        cell = dataclasses.replace(cell, mix={**cell.mix, **mix})
    gen = manifest.load_module("generators", cell.mix["generator"])
    names = list(cell.config["patterns"])
    patterns = list(manifest.regexes(cell.config).values())
    out = []
    for seed in seeds:
        pool = gen.make_pool(cell.config, cell.mix, seed)
        want = harness.reference_decisions(cell, pool, range(len(pool)),
                                           workers)
        calls = []
        for e, docs in enumerate(pool):
            t0 = time.perf_counter()
            acc = membership.decide(patterns, docs, workers=workers,
                                    split=split)
            calls.append(harness.Call(e, t0, time.perf_counter(),
                                      sum(map(len, docs)),
                                      acc.size, acc))
        checks = harness.check(calls, want, cell.limits)
        rows = np.concatenate([want[e] for e in range(len(pool))])
        out.append({"seed": seed,
                    **{k: v["value"] for k, v in checks.items()},
                    "share_matching": {n: float(s) for n, s in
                                       zip(names, rows.mean(axis=0))}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    for r in readings(args.workload, args.seeds,
                      workers=min(8, os.cpu_count() or 1)):
        print(json.dumps({"workload": args.workload, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
