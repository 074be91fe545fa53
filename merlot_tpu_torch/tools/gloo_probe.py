"""Which gloo collectives take CUDA tensors when two ranks share one card.

    python -m merlot_tpu_torch.tools.gloo_probe

NCCL refuses two ranks on one device, so a one-card machine runs the mesh's
model axis as gloo ranks (chip_smoke.py's tensor_parallel phase). This tool
starts two processes on ``cuda:0`` over gloo and tries, on CUDA tensors,
each collective that path needs: all-reduce (sum in fp32 and bf16, max,
min), broadcast, all-gather, groups of one and of two ranks, an object
broadcast; then it times a 64 MB fp32 all-reduce. Each rank prints one
line ``RESULT <rank> <json>``; a collective that fails reads ``FAIL ...``.
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist


def _rank(rank: int, port: int) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {}

    def probe(name, fn):
        try:
            out[name] = fn()
        except RuntimeError as e:
            out[name] = f"FAIL {type(e).__name__}: {str(e)[:200]}"

    def all_reduce(dtype, op, group=None):
        t = torch.full((1000,), float(rank + 1), dtype=dtype, device=dev)
        dist.all_reduce(t, op=op, group=group)
        return float(t[0].float())

    probe("all_reduce_sum_fp32", lambda: all_reduce(torch.float32, dist.ReduceOp.SUM))
    probe("all_reduce_sum_bf16", lambda: all_reduce(torch.bfloat16, dist.ReduceOp.SUM))
    probe("all_reduce_max_fp32", lambda: all_reduce(torch.float32, dist.ReduceOp.MAX))
    probe("all_reduce_min_int64", lambda: all_reduce(torch.int64, dist.ReduceOp.MIN))

    def broadcast():
        t = torch.full((10,), float(rank + 5), device=dev)
        dist.broadcast(t, src=0)
        return float(t[0])
    probe("broadcast_fp32", broadcast)

    def all_gather():
        t = torch.full((4,), float(rank), device=dev)
        parts = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(parts, t)
        return [float(p[0]) for p in parts]
    probe("all_gather_fp32", all_gather)

    # every rank makes every group, in the same order
    singles = [dist.new_group([0]), dist.new_group([1])]
    pair = dist.new_group([0, 1])
    probe("group_of_one_all_reduce",
          lambda: all_reduce(torch.float32, dist.ReduceOp.SUM, singles[rank]))
    probe("group_of_two_all_reduce",
          lambda: all_reduce(torch.float32, dist.ReduceOp.SUM, pair))

    def broadcast_object():
        box = [{"rank": rank}]
        dist.broadcast_object_list(box, src=0)
        return box[0]
    probe("broadcast_object", broadcast_object)

    def seconds_64mb():
        t = torch.ones((16 << 20,), device=dev)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            dist.all_reduce(t)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 5
    probe("all_reduce_64MB_fp32_s", seconds_64mb)
    dist.barrier()
    print("RESULT", rank, json.dumps(out), flush=True)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_probe: no CUDA device", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-m", "merlot_tpu_torch.tools.gloo_probe",
                               "--rank", str(r), str(port)]) for r in range(2)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return max(rcs)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        _rank(int(sys.argv[2]), int(sys.argv[3]))
    else:
        sys.exit(main())
