"""Which ``gloo`` calls of ``torch.distributed`` take CUDA tensors.

Each call runs in its own pair of processes on card 0, joined over a free
localhost port, on a 6-element float64 tensor, so that a call that aborts its
process (as ``gloo``'s send and receive do on a device pointer: "writev: Bad
address") does not take the others with it. Prints, per call and rank, the
exit code and what the process said. Needs one CUDA device::

    python3 scripts/gloo_cuda_probe.py

``parallel/distributed.py`` follows what this prints: the all-reduce and the
all-gather take CUDA tensors, the point-to-point exchange stages them
through pinned host memory.
"""

import datetime
import json
import socket
import subprocess
import sys
import time

CALLS = ["all_reduce", "all_gather", "all_gather_into_tensor", "broadcast", "batch_isend_irecv", "send_recv"]


def worker(call: str, port: int, rank: int) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=30))
    x = torch.arange(6, dtype=torch.float64, device="cuda:0") + 10 * rank
    try:
        if call == "all_reduce":
            dist.all_reduce(x)
            out = x
        elif call == "all_gather":
            outs = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(outs, x)
            out = torch.cat(outs)
        elif call == "all_gather_into_tensor":
            out = torch.empty(12, dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x)
        elif call == "broadcast":
            dist.broadcast(x, src=0)
            out = x
        elif call == "batch_isend_irecv":
            out = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x, 1 - rank, tag=3), dist.P2POp(dist.irecv, out, 1 - rank, tag=3)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        else:
            out = torch.empty_like(x)
            if rank == 0:
                dist.send(x, 1)
                dist.recv(out, 1)
            else:
                dist.recv(out, 0)
                dist.send(x, 0)
        torch.cuda.synchronize()
        print(json.dumps({"call": call, "rank": rank, "ok": True, "out": out.cpu().tolist()}), flush=True)
    except RuntimeError as exc:  # what the backend refused, and how
        print(json.dumps({"call": call, "rank": rank, "ok": False, "error": str(exc)[:400]}), flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 3
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    workers = []
    for call in CALLS:
        port = _free_port()
        workers += [(call, rank, subprocess.Popen([sys.executable, __file__, call, str(port), str(rank)],
                                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
                    for rank in range(2)]
    deadline = time.monotonic() + 120
    for call, rank, process in workers:
        try:
            out, err = process.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            process.kill()
            out, err = process.communicate()
        print(f"{call} rank {rank}: exit {process.returncode} {out.strip()[-600:]} {err.strip()[-600:]}", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
    else:
        sys.exit(main())
