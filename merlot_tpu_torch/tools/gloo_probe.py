"""Which gloo collectives and point-to-point ops take CUDA tensors when two
ranks share one card.

    python -m merlot_tpu_torch.tools.gloo_probe

NCCL refuses two ranks on one device, so a one-card machine runs the mesh's
model and stage axes as gloo ranks (chip_smoke.py's tensor_parallel and
pipeline_parallel phases). This tool starts two processes on ``cuda:0``
over gloo and tries, on CUDA tensors, each collective those paths need:
all-reduce (sum in fp32 and bf16, max, min), broadcast, all-gather, groups
of one and of two ranks, an object broadcast; then it times a 64 MB fp32
all-reduce and a 24 MB hop (one pipeline microbatch's [1, 1536, 1024] fp32
activation at 4x headroom) through pinned host buffers, the pipeline's
gloo transport; last, the point-to-point ops on CUDA tensors themselves
(``send``/``recv``, ``isend``/``irecv``, ``batch_isend_irecv``), each
checked for the values that arrive, under a 20 s wait. Each rank prints a
line ``PROBE <rank> <name> <json>`` as each probe ends and one line
``RESULT <rank> <json>``; a probe that fails reads ``FAIL ...``.
"""

from __future__ import annotations

import datetime
import json
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist


def _rank(rank: int, port: int) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {}

    def probe(name, fn):
        try:
            out[name] = fn()
        except Exception as e:  # noqa: BLE001 -- every failure is a finding

            out[name] = f"FAIL {type(e).__name__}: {str(e)[:200]}"
        print("PROBE", rank, name, json.dumps(out[name]), flush=True)

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

    def hop_via_host():
        """Seconds of one 24 MB hop, device to device through pinned host
        buffers (the copies included): half a round trip, mean of 5."""
        t = torch.full((6 << 20,), float(rank + 1), device=dev)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)

        def one(src):
            if rank == src:
                host.copy_(t)
                dist.send(host, 1 - src, tag=7)
            else:
                dist.recv(host, src, tag=7)
                t.copy_(host)
                torch.cuda.synchronize()
        one(0), one(1)
        t0 = time.perf_counter()
        for _ in range(5):
            one(0)
            one(1)
        return (time.perf_counter() - t0) / 10

    probe("hop_24MB_via_pinned_host_s", hop_via_host)
    dist.barrier()

    # point-to-point on CUDA tensors, last: a backend that takes the device
    # pointer for a host one may crash a rank (the other's wait then fails)
    wait = datetime.timedelta(seconds=20)

    def p2p(kind, tag):
        sent = torch.arange(1024, dtype=torch.float32, device=dev) + 1
        got = torch.zeros_like(sent)
        if kind == "send_recv":
            dist.send(sent, 1, tag=tag) if rank == 0 else dist.recv(got, 0, tag=tag)
        elif kind == "isend_irecv":
            work = dist.isend(sent, 1, tag=tag) if rank == 0 else dist.irecv(got, 0, tag=tag)
            work.wait(wait)
        else:
            op = (dist.P2POp(dist.isend, sent, 1, tag=tag) if rank == 0
                  else dist.P2POp(dist.irecv, got, 0, tag=tag))
            for work in dist.batch_isend_irecv([op]):
                work.wait(wait)
        torch.cuda.synchronize()
        return "sent" if rank == 0 else bool(torch.equal(got, sent))

    for i, kind in enumerate(("send_recv", "isend_irecv", "batch_isend_irecv")):
        probe(f"p2p_cuda_{kind}", lambda kind=kind, i=i: p2p(kind, 100 + i))
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
