"""Runs a piece of the PyTorch port on several gloo ranks of one
`torch.distributed` process group, each a `python -c` subprocess on the CPU
with one thread, and collects what each rank saved.

A rank program is the body of a function of `(rank, n, args, out)`: `args`
is the dict passed in (numpy arrays allowed), `out` a dict the body fills
with numpy arrays or numbers; it comes back as ``results[rank]``.  The
group is formed from the environment through `parallel.multihost.initialize`
on a free localhost port.
"""

import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """
import os, pickle, sys
rank, n, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
sys.path[:0] = [{repo!r}, os.path.join({repo!r}, "tests")]
import numpy as np
import torch
torch.set_num_threads(1)
from densemonoslam_tpu_torch.parallel import multihost
from torch_ranks import as_numpy
assert multihost.initialize(backend="gloo")
with open(os.path.join(path, "args.pkl"), "rb") as f:
    args = pickle.load(f)
out = {{}}
def body(rank, n, args, out):
{body}
body(rank, n, args, out)
with open(os.path.join(path, f"out{{rank}}.pkl"), "wb") as f:
    pickle.dump(out, f)
torch.distributed.destroy_process_group()
print("RESULT ok", flush=True)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(n: int, body: str, args: dict, tmp_path, timeout: float = 240.0) -> list:
    """Run `body` on `n` ranks; returns each rank's `out` dict."""
    with open(tmp_path / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    code = _PRELUDE.format(repo=REPO, body=textwrap.indent(textwrap.dedent(body), "    "))
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(DMS_COORDINATOR=f"127.0.0.1:{port}", DMS_NUM_HOSTS=str(n),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    # each rank's output goes to a file: a rank that filled a pipe nobody
    # reads yet would stall its peers at a collective
    procs = []
    try:
        for r in range(n):
            with open(tmp_path / f"rank{r}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, str(r), str(n), str(tmp_path)],
                    stdout=log, stderr=subprocess.STDOUT, env={**env, "DMS_HOST_ID": str(r)},
                ))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    errors = []
    for r, p in enumerate(procs):
        out = (tmp_path / f"rank{r}.log").read_text()
        if p.returncode != 0 or "RESULT ok" not in out:
            errors.append(f"rank {r} exited {p.returncode}:\n{out[-3000:]}")
    assert not errors, "\n".join(errors)
    results = []
    for r in range(n):
        with open(tmp_path / f"out{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def as_numpy(x):
    """Tensors (and named tuples of them) to numpy, for a rank's `out`."""
    if hasattr(x, "_fields"):
        return {k: as_numpy(v) for k, v in x._asdict().items()}
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
