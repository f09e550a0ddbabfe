"""The driver the timing scripts share (time_mc_render.py, time_mesh_mc.py,
time_kernels.py): one measurement in one or more checkouts of the repo,
each in a process of its own, in the order given, and a summary.

A script defines ``one(root, out, repeats) -> dict``: it imports the port
found under ``root`` (``use_checkout``), measures, saves the outputs that
must not change (a dict of tensors) to ``out`` with ``torch.save``, and
returns a JSON-able dict holding ``root`` and a list of samples under each
metric.  Its ``__main__`` calls ``main``.  To compare two commits, unpack
each into a directory that .gitignore lists and give them as A B B A:

    python3 time_kernels.py build/parent . . build/parent

Prints one JSON line a run, then the card's name and power limit, then a
summary line: each metric's median, min and max per checkout, and whether
each run's outputs are bit equal to its checkout's first run (required)
and to the first run of all (required where the script says so).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PORT = "cpu_based_ray_tracer_tpu_torch"


def use_checkout(root: str) -> None:
    """Put the checkout ``root`` first on sys.path and check that the port
    is imported from it."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import cpu_based_ray_tracer_tpu_torch as port

    pkg = os.path.dirname(os.path.abspath(port.__file__))
    if pkg != os.path.join(root, PORT):
        raise RuntimeError(f"imported the port from {pkg}, not from {root}")


def spread(xs) -> dict:
    """Median, min and max of a list of samples."""
    return dict(median=statistics.median(xs), min=min(xs), max=max(xs))


def smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def _equal(a: dict, b: dict) -> dict:
    """Each output of a against b, bit for bit (floats as int32 words)."""
    import torch

    def bits(x):
        return x.view(torch.int32) if x.is_floating_point() else x
    return {k: torch.equal(bits(a[k]), bits(b[k])) for k in a}


def main(script: str, doc: str, one, metrics, repeats: int,
         equal_across: bool) -> None:
    """The command line of ``script`` (its docstring ``doc``): run ``one``
    in each checkout given, ``repeats`` samples each, and summarise the
    ``metrics``.  With ``equal_across`` every run's outputs must be bit
    equal to the first run's; without, only to the first run of their own
    checkout (the summary still says whether the checkouts agree)."""
    name = os.path.splitext(os.path.basename(script))[0]
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", help="checkouts of the repo")
    ap.add_argument("--repeats", type=int, default=repeats)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print(json.dumps(one(a.roots[0], a.out, a.repeats)), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(f"{name}: CUDA is not available")
    out_dir = os.path.join(HERE, "build", name)
    os.makedirs(out_dir, exist_ok=True)
    runs = []
    for i, root in enumerate(a.roots):
        out = os.path.join(out_dir, f"run{i}.pt")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(script), os.path.abspath(root),
             "--one", "--out", out, "--repeats", str(a.repeats)],
            capture_output=True, text=True, timeout=900,
            cwd=os.path.abspath(root))
        if proc.returncode != 0:
            raise SystemExit(f"run {i} ({root}) failed:\n{proc.stderr}")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append((json.loads(line), torch.load(out)))
    by_root, first = {}, {}
    for res, outs in runs:
        by_root.setdefault(res["root"], []).append(res)
        first.setdefault(res["root"], outs)
    within = [all(_equal(outs, first[res["root"]]).values())
              for res, outs in runs]
    across = [_equal(outs, runs[0][1]) for _, outs in runs]
    ok = all(within) and (not equal_across
                          or all(all(e.values()) for e in across))
    print(smi(), flush=True)
    print(json.dumps({
        "ok": ok, "equal_within_checkout": within,
        "equal_to_run0": across,
        "spread": {root: {m: spread([x for res in rs for x in res[m]])
                          for m in metrics}
                   for root, rs in by_root.items()}}), flush=True)
    if not ok:
        raise SystemExit(f"{name}: the runs' outputs differ")
