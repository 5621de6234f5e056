"""Run one cell of the benchmark of ``metrics_tpu_torch`` and print its result as the last line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics. Without as many CUDA cards as the cell asks for it exits with 2
and prints no result; it has no CPU fallback. The numbers compared with the reference are printed,
each beside its limit, as the last lines of standard error and under ``checks`` in the result.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache a library may write, at a fixed place inside the checkout (the nvcc builds of the
# program go to metrics_tpu_torch/_build/, also inside it)
CACHE = ROOT / ".portbench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"  # transformers, where present, would otherwise load JAX
os.environ["USE_TF"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.cells(ROOT).get(args.workload)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if args.seed < 0:
        print("--seed must not be negative", file=sys.stderr)
        return 2
    result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T0)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"refusing to report: the process loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, number in result["checks"].items():
        print(f"check {name}: {number['value']!r} (limit {number['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
