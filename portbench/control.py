"""The control of a cell's comparison: the plain reference computed in the
nearest precision below the configuration's (bfloat16 for float32) put in
the program's place, at the cell's own sizes, on the seeds given; for the
training cell also the faults planted in the reference (half of the batch
left out of the loss, a parameter altered after each update).  It prints
one JSON line a seed and reading: each compared number beside its limit.
A sound comparison fails the control on every seed.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--faults]

Needs a CUDA card; ``portbench/tests/test_portbench_runs.py`` runs
``readings`` on the CPU at small sizes.  The benchmark's own runs do not
run it."""

import os
import sys

if __name__ == "__main__":     # run as a script from the checkout's root
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from portbench import harness  # noqa: E402

FAULTS = ("half_batch", "altered")


def readings(workload: str, seed: int, device, faults: bool, params=None):
    """[(what, {number: value})] of the control (and the faults) of one
    seed."""
    bench = harness.load_benchmark()
    _, config, traffic = harness.cell_spec(bench, workload)
    p = dict(traffic["params"])
    p.update(params or {})
    ctx = harness.Context(workload, config, p, seed, device, False)
    drv = importlib.import_module(
        f"portbench.drivers.{traffic['driver']}").Driver(ctx)
    out = [("control_bfloat16", drv.control(torch.bfloat16))]
    if faults:
        for f in FAULTS:
            out.append((f"fault_{f}", drv.control(torch.float32, fault=f)))
    return out, p["limits"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    for seed in args.seeds:
        t0 = time.perf_counter()
        rows, limits = readings(args.workload, seed, dev, args.faults)
        for what, nums in rows:
            print(json.dumps({
                "workload": args.workload, "seed": seed, "reading": what,
                "seconds": time.perf_counter() - t0,
                "numbers": {k: {"value": v, "limit": limits[k]}
                            for k, v in nums.items()},
                "fails": any(not v <= limits[k] for k, v in nums.items())}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
