"""Whether NCCL accepts two ranks of one communicator on one GPU.

    python3 tools/nccl_one_card_probe.py

Starts two processes that join one NCCL process group on `cuda:0` and
all-reduce a tensor, each under a time limit, and prints what each rank
reported.  It exits 0 whatever NCCL does: the answer is the printed
outcome (`chip_smoke.py` runs its two ranks on one card over gloo
because of it).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

_RANK = """
import sys, datetime, torch, torch.distributed as dist
rank, port = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
x = torch.ones(4, device="cuda")
try:
    dist.all_reduce(x)
    torch.cuda.synchronize()
    print(f"rank {rank}: all_reduce returned {x.tolist()}", flush=True)
except Exception as e:
    print(f"rank {rank}: {type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''}", flush=True)
    for line in str(e).splitlines()[1:6]:
        print(f"rank {rank}:   {line}", flush=True)
dist.destroy_process_group()
"""


def main() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "NCCL_DEBUG": "WARN"}
    procs = [
        subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(port)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)
    ]
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\n(killed after 180 s)"
        lines = [line for line in out.splitlines() if line.strip()]
        print(f"[nccl probe] rank {r} exited {p.returncode}; last lines:")
        for line in lines[-12:]:
            print(f"[nccl probe]   {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
