"""Which ``torch.distributed`` calls a gloo group runs on CUDA tensors, and
how long two of them take: four ranks on one card.

    python3 tools/torch_gloo_probe.py

Spawns four processes on device 0 (a ``file://`` rendezvous in a temporary
directory), tries ``all_reduce`` (SUM, MAX, MIN, AVG), ``all_gather``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``reduce_scatter``,
``all_to_all_single`` and ``all_to_all`` on int32, float32, uint8 and int8
tensors, and times ``all_gather`` and ``all_reduce`` of 4 MB and 84 MB
float32 tensors (three calls, mean). Prints one line a call: ``ok`` with the
result's head, or ``FAIL`` with the error. Without a card it exits 1 and
measures nothing.
"""
import os
import subprocess
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def worker(rank, init, results):
    out = {}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD)
        dev = torch.device("cuda", 0)

        def attempt(name, fn):
            try:
                r = fn()
                torch.cuda.synchronize()
                out[name] = "ok " + str(r)[:80]
            except Exception as err:  # noqa: BLE001 -- the probe reports what the backend refuses
                out[name] = "FAIL " + type(err).__name__ + ": " + str(err).splitlines()[0][:200]

        for dt in (torch.int32, torch.float32, torch.uint8, torch.int8):
            x = (torch.arange(8, device=dev) + rank).to(dt)
            for op in ("SUM", "MAX", "MIN", "AVG"):
                def reduce(op=op, x=x):
                    y = x.clone()
                    dist.all_reduce(y, op=getattr(dist.ReduceOp, op))
                    return y.tolist()
                attempt(f"all_reduce {op} {dt}", reduce)

            def gather_list(x=x):
                ys = [torch.empty_like(x) for _ in range(WORLD)]
                dist.all_gather(ys, x)
                return [y.tolist()[:2] for y in ys]

            def gather_tensor(x=x):
                y = torch.empty((WORLD * 8,), dtype=x.dtype, device=dev)
                dist.all_gather_into_tensor(y, x)
                return y.tolist()[:10]

            def scatter_tensor(x=x):
                y = torch.empty_like(x)
                dist.reduce_scatter_tensor(y, torch.cat([x] * WORLD))
                return y.tolist()

            def scatter_list(x=x):
                y = torch.empty_like(x)
                dist.reduce_scatter(y, [x.clone() for _ in range(WORLD)])
                return y.tolist()

            def swap_tensor(x=x):
                inp = torch.cat([x] * WORLD)
                y = torch.empty_like(inp)
                dist.all_to_all_single(y, inp)
                return y.tolist()[:10]

            def swap_list(x=x):
                outs = [torch.empty_like(x) for _ in range(WORLD)]
                dist.all_to_all(outs, [x.clone() for _ in range(WORLD)])
                return outs[1].tolist()

            for name, fn in (("all_gather", gather_list), ("all_gather_into_tensor", gather_tensor),
                             ("reduce_scatter_tensor", scatter_tensor), ("reduce_scatter", scatter_list),
                             ("all_to_all_single", swap_tensor), ("all_to_all", swap_list)):
                attempt(f"{name} {dt}", fn)
        for n in (1 << 20, 21_000_000):  # 4 MB and 84 MB of float32 a rank
            x = torch.ones(n, device=dev)
            ys = [torch.empty_like(x) for _ in range(WORLD)]
            dist.all_gather(ys, x)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(3):
                dist.all_gather(ys, x)
            torch.cuda.synchronize()
            out[f"all_gather f32 n={n} ms"] = (time.perf_counter() - t) / 3 * 1e3
            t = time.perf_counter()
            for _ in range(3):
                dist.all_reduce(x)
            torch.cuda.synchronize()
            out[f"all_reduce f32 n={n} ms"] = (time.perf_counter() - t) / 3 * 1e3
        dist.barrier()
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 -- sent to the parent, which prints it
        out["error"] = traceback.format_exc()
    results.put((rank, out))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gloo_probe: no CUDA device; the probe measures gloo on CUDA tensors only", file=sys.stderr)
        return 1
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=worker, args=(r, init, results)) for r in range(WORLD)]
        t = time.perf_counter()
        for p in procs:
            p.start()
        outs = dict(results.get(timeout=240) for _ in range(WORLD))
        for p in procs:
            p.join(30)
    print("spawn and run s", time.perf_counter() - t)
    for key, value in outs[0].items():
        print(key, "|", value, "| rank 1:", outs[1].get(key))
    errors = {r: o["error"] for r, o in outs.items() if "error" in o}
    print(errors or "no rank failed")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
