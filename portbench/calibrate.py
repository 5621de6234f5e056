"""The readings the limits of ``correct`` are set from: the program's compared numbers over many
seeds (the lower readings) and the control's, the reference one precision down in the program's
place, over the same seeds (the upper readings), at the cell's own size, in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 11,12,... --seconds <s>

Each seed makes its pool, drives the program for ``--seconds`` of whole epochs as a run does, frees it,
and prints one line of the largest number of each kind over the epochs, for the program and the
control; the last line holds each number's lower reading (the largest over the program's seeds) and
upper reading (the smallest over the control's).
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.cells(ROOT)[args.workload]
    lower, upper = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        task = harness.task_class(cell.config)(cell.config, cell.mix, seed, device)
        task.build()
        task.warm()
        start = time.perf_counter()
        while time.perf_counter() - start < args.seconds:
            task.epoch()
        task.free_program()
        gc.collect()
        for kind, store in (("program", lower), ("control", upper)):
            numbers = harness.check(cell, task, control=kind == "control")["numbers"]
            values = {k: v["value"] for k, v in numbers.items()}
            for k, v in values.items():
                store[k] = max(store.get(k, v), v) if kind == "program" else min(store.get(k, v), v)
            print(json.dumps({"seed": seed, "kind": kind, "epochs": len(task.epochs), **values}), flush=True)
        del task
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
