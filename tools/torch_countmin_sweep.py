"""Times the session axis of the ``countmin`` kernel at each launch shape it
can take, at one fleet shard flush, so that its plan can be chosen from
measurements on the card.

    python3 tools/torch_countmin_sweep.py [--sessions 256] [--n 4096] [--width 1024] [--reps N]

Builds ``csrc/countmin.cu`` and launches ``countmin_sessions_launch`` on
``--sessions`` tables of ``chip_smoke.CLICK_DEPTH`` x ``--width`` with ``--n``
Zipf click ids each (``chip_smoke.zipf_ids``, weight 1, from a seed): the
``sessions`` branch with every warp count whose tables fit a block's shared
memory, and the ``sessions-global`` branch. Each launch is first held equal to
the plain version, then timed with ``chip_smoke.device_ms`` (the kernels
line's method), as is ``index_add_`` on the precomputed cells. Prints the
card's name and power limit, then one JSON line: each launch's time, the
plan's pick and the bound. Without a card it exits 1 and measures nothing.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sessions", type=int, default=256)
    parser.add_argument("--n", type=int, default=4096)
    parser.add_argument("--width", type=int, default=1024)
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("torch_countmin_sweep: no CUDA device is visible", file=sys.stderr)
        return 1
    import metrics_tpu_torch as M
    from metrics_tpu_torch.ops import sketch_ops
    from metrics_tpu_torch.streaming.sketch import _key_bits

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    sessions, n, depth, width = args.sessions, args.n, smoke.CLICK_DEPTH, args.width
    g = torch.Generator(device=dev).manual_seed(smoke.SEED + 151)
    keys = smoke.zipf_ids(torch, g, sessions * n).reshape(sessions, n)
    bits = _key_bits(keys).contiguous().view(torch.int32)
    w = torch.ones(sessions, n, device=dev)
    seeds = M.CountMinHeavyHitters(depth=depth, width=width, device=dev)._seeds().view(torch.int32).contiguous()
    values = torch.randint(0, 1000, (sessions, depth, width), generator=g, device=dev).float()
    want = sketch_ops._countmin_sessions_plain(values, bits, w, seeds)
    lib = sketch_ops._lib()
    sms, optin = sketch_ops._device_limits(dev)
    out = torch.empty_like(values)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(warps, blocks):
        err = lib.countmin_sessions_launch(bits.data_ptr(), w.data_ptr(), seeds.data_ptr(), sessions, n, depth,
                                           width, values.data_ptr(), out.data_ptr(), warps, blocks, stream)
        if err:
            raise RuntimeError(lib.countmin_error_string(err).decode())

    table_bytes = 4 * (-(-depth * width // 4) * 4 + 32)  # a warp's table and its staged weights
    shapes = [("sessions", warps, sessions) for warps in range(1, 9) if warps * table_bytes <= optin]
    shapes.append(("sessions-global", 0, max(1, min(8 * sms, -(-(sessions * n) // 256)))))
    rows = []
    for branch, warps, blocks in shapes:
        out.zero_()
        launch(warps, blocks)
        if not torch.equal(out, want):
            raise RuntimeError(f"{branch} with {warps} warps differs from the plain version")
        rows.append({"branch": branch, "warps": warps, "blocks": blocks,
                     "ms": smoke.device_ms(torch, lambda: launch(warps, blocks), reps=args.reps)})
    u32 = sketch_ops.as_u32_bits
    hashed = sketch_ops.hash_u32(u32(bits)[:, None, :] ^ u32(seeds)[None, :, None])
    cells = (hashed % width + torch.arange(depth, device=dev)[None, :, None] * width
             + torch.arange(sessions, device=dev)[:, None, None] * (depth * width)).reshape(-1)
    wts = w[:, None, :].expand(-1, depth, -1).reshape(-1).contiguous()
    table = torch.zeros(sessions * depth * width, device=dev)
    bound = smoke.bound(sessions * n * 8 + depth * 4 + 2 * sessions * depth * width * 4, sessions * n * depth * 11)
    print(json.dumps({
        "card": card, "shape": {"S": sessions, "n": n, "depth": depth, "width": width}, "sms": sms,
        "shared_optin": optin, "launches": rows,
        "plan": sketch_ops.countmin_sessions_plan(sessions, n, depth, width, sms, optin),
        "index_add_ms": smoke.device_ms(torch, lambda: table.index_add_(0, cells, wts), reps=args.reps),
        "bound_ms": bound[0], "bound_by": bound[1],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
