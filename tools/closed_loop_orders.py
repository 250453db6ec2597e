"""The closed-loop leg of `chip_smoke.py` once per pairing of Gram and
deformation kernels, on one NVIDIA GPU: the current kernels (K1
`csrc/gram.cu`, K2 `csrc/deform.cu`), their previous designs
(`csrc/prev/`), and cuBLAS (`M.T @ M`) in place of K1.  Every pairing is
deterministic and within the kernels' tolerances of the plain versions;
they differ only in the order in which the sums round.  The leg's ATE,
closures and map size per pairing show how far that order alone moves the
leg's end-to-end numbers.

    python3 tools/closed_loop_orders.py

Needs a CUDA card (builds the kernels with nvcc like `chip_smoke.py`);
prints one `[orders]` line per pairing and then its JSON summary.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from densemonoslam_tpu_torch.ops import deform, gram  # noqa: E402
from densemonoslam_tpu_torch.utils import launches  # noqa: E402


KEPT = ("ate_mm", "loops_timed", "loops_all", "surfels")


def _counted(fn, kernel, by_shape=False):
    """`fn` as a launch the leg's launch checks count."""
    def call(*args):
        launches.add(kernel, tuple(args[0].shape) if by_shape else None)
        return fn(*args)
    return call


def main() -> int:
    smi = cs.phase_device()
    grams = {
        "current": gram.gram_cuda,
        "previous": _counted(cs.prev_gram, "gram", by_shape=True),
        "cuBLAS": _counted(gram.gram_reference, "gram", by_shape=True),
    }
    deforms = {"current": deform.deform_map_cuda, "previous": _counted(cs.prev_deform, "deform")}
    pairs = [("current", "current"), ("previous", "current"), ("current", "previous"),
             ("previous", "previous"), ("cuBLAS", "current")]
    rows = []
    for k1, k2 in pairs:
        gram.gram_cuda, deform.deform_map_cuda = grams[k1], deforms[k2]
        cs.log(f"[orders] K1 {k1}, K2 {k2}:")
        out = cs.phase_closed_loop()
        rows.append(dict(k1=k1, k2=k2, **{k: out[k] for k in KEPT}))
        cs.log(f"[orders] K1 {k1}, K2 {k2}: " + json.dumps(rows[-1]))
        del out
    gram.gram_cuda, deform.deform_map_cuda = grams["current"], deforms["current"]
    cs.log(smi)
    print(json.dumps({"orders": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
