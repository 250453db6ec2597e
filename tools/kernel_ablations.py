"""Where the time of K1 (`csrc/gram.cu`) and K2 (`csrc/deform.cu`) goes, on
one NVIDIA GPU.  Each kernel is built again with a part cut out (an
ablation), and every build is timed on the same inputs, in alternating
rounds, beside the current kernel and its previous design (`csrc/prev/`):

K1, at each shape of `chip_smoke.GRAM_SHAPES`:
  empty     returns at entry: the launch alone;
  no_tail   returns before the ticket: the copies, the math and the block's
            own sum;
  no_read   the last block resets the ticket and returns: all but its read
            and sum of the partial triangles.
K2, on the closed-loop leg's map and its last closure's graph:
  per_thread  no uniform path: every warp takes the per-thread path;
  rows_only   reads each row's two sectors and returns: the stream;
  first_5     per-thread path over 5 candidates instead of 20;
  no_blend    selects the 5 nearest, writes them, skips the blend.

An ablation's output is wrong by design; only the current kernel's and the
per-thread build's outputs are checked against the current kernel.

    python3 tools/kernel_ablations.py

Prints one line per build (median and each round's device time from CUDA
events, as `chip_smoke.device_ms` takes them), then the card's name and
power limit and a JSON summary.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from densemonoslam_tpu_torch.ops import cuda_build, deform, gram  # noqa: E402

ROUNDS = 4


def _cut(src: str, anchor: str, new: str) -> str:
    """`src` with its one `anchor` replaced by `new`."""
    if src.count(anchor) != 1:
        raise RuntimeError(f"ablation anchor found {src.count(anchor)} times: {anchor!r}")
    return src.replace(anchor, new)


def _before(src: str, anchor: str, lines: str) -> str:
    return _cut(src, anchor, lines + anchor)


def gram_builds(src: str) -> dict:
    ret = "  if (P >= 0) return;  // ablation\n"
    return {
        "current": src,
        "empty": _before(src, "  const int t = threadIdx.x;\n  const int tile", ret),
        "no_tail": _before(src, "  // The barrier orders the block's partial writes", ret),
        "no_read": _cut(src, "  if (!s_last) return;\n",
                        "  if (!s_last) return;\n  if (t == 0) *ticket = 0;\n" + ret),
    }


def deform_builds(src: str) -> dict:
    per_thread = _cut(src, "    if (first == last) {\n", "    if (false) {\n")
    return {
        "current": src,
        "per_thread": per_thread,
        "rows_only": _before(src, "    const unsigned live_lanes = __ballot_sync(FULL, live);\n",
                             "    if (p.x + n.x == 1234.5f) row[1] = p;\n    continue;\n"),
        "first_5": _cut(per_thread, "      for (int q = 0; q < LOOKBACK; ++q) {\n        const int j = start + q;",
                        "      for (int q = 0; q < NEAREST; ++q) {\n        const int j = start + q;"),
        "no_blend": _cut(src, "    if (!live) continue;\n",
                         "    if (!live) continue;\n    row[0] = make_float4(bd[0] + bd[4], "
                         "__int_as_float(bi[0] + bi[3]), bd[2], p.w);\n    continue;\n"),
    }


def build_all(builds: dict, out: Path) -> dict:
    """Compile every (kernel, build) source, one nvcc each, all at once."""
    nvcc = cuda_build._nvcc()
    procs = {}
    for key, src in builds.items():
        cu = out / f"{key[0]}_{key[1]}.cu"
        cu.write_text(src)
        lib = out / f"lib{key[0]}_{key[1]}.so"
        procs[key] = (lib, subprocess.Popen([nvcc, *cuda_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def gram_call(lib, scratch, M):
    out = torch.empty(M.shape[1], M.shape[1], device=M.device)
    err = lib.gram_f32(M.data_ptr(), M.shape[0], M.shape[1], scratch[0].data_ptr(),
                       scratch[1].data_ptr(), out.data_ptr(), M.device.index,
                       torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gram launch failed: cudaError {err}")
    return out


def deform_call(lib, data, count, graph):
    K = graph.pos.shape[0]
    table = torch.empty(16 * K + 4, device=data.device)
    valid = graph.valid.contiguous().view(torch.uint8)
    err = lib.deform_map_f32(data.data_ptr(), data.shape[0] - 1, count.data_ptr(),
                             graph.pos.data_ptr(), graph.time.data_ptr(), valid.data_ptr(),
                             graph.A.data_ptr(), graph.t.data_ptr(), K, table.data_ptr(),
                             data.device.index, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"deform launch failed: cudaError {err}")
    return data


def rounds(calls: dict) -> dict:
    """Device us per call of each build, ROUNDS rounds in alternating order."""
    times = {name: [] for name in calls}
    names = list(calls)
    for r in range(ROUNDS):
        for name in names if r % 2 == 0 else names[::-1]:
            times[name].append(1e3 * cs.device_ms(calls[name]))
    return times


def report(label: str, times: dict) -> dict:
    med = {name: float(np.median(v)) for name, v in times.items()}
    for name, v in times.items():
        cs.log(f"[ablation] {label} {name:10s} median {med[name]:7.2f} us  "
               f"({', '.join(f'{x:.2f}' for x in v)})")
    return med


def main() -> int:
    smi = cs.phase_device()
    sources = {"gram": (cuda_build.CSRC / "gram.cu").read_text(),
               "deform": (cuda_build.CSRC / "deform.cu").read_text()}
    builds = {("gram", k): v for k, v in gram_builds(sources["gram"]).items()}
    builds.update({("deform", k): v for k, v in deform_builds(sources["deform"]).items()})
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    summary = {}
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        libs = build_all(builds, Path(tmp))
        grams, deforms = {}, {}
        for (kernel, name), lib in libs.items():
            if kernel == "gram":
                gram._declare(lib)
                grams[name] = (lib, (torch.empty(lib.gram_scratch_floats(), device="cuda"),
                                     torch.zeros(1, dtype=torch.int32, device="cuda")))
            else:
                deform._declare(lib)
                deforms[name] = lib

        gen = np.random.default_rng(0)
        for P, C in cs.GRAM_SHAPES:
            M = torch.from_numpy(gen.normal(0, 1, (P, C)).astype(np.float32)).cuda()
            if not torch.equal(gram_call(*grams["current"], M), gram.gram(M)):
                raise AssertionError(f"gram {P}x{C}: the rebuilt kernel differs from the port's")
            calls = {name: (lambda lib=lib, s=s: gram_call(lib, s, M))
                     for name, (lib, s) in grams.items()}
            calls["previous"] = lambda: cs.prev_gram(M)
            summary[f"gram {P}x{C}"] = report(f"gram {P}x{C}", rounds(calls))

        closed = cs.phase_closed_loop()
        data, count, graph = closed["data"], closed["count"], closed["graph"]
        want = deform.deform_map(data.clone(), count, graph)
        for name in ("current", "per_thread"):
            if not torch.equal(deform_call(deforms[name], data.clone(), count, graph), want):
                raise AssertionError(f"deform {name}: differs from the port's kernel")
        # each build deforms its own copy of the map in place, call after call
        calls = {name: (lambda lib=lib, m=data.clone(): deform_call(lib, m, count, graph))
                 for name, lib in deforms.items()}
        calls["previous"] = lambda m=data.clone(): cs.prev_deform(m, count, graph)
        summary["deform closed-loop map"] = report("deform closed-loop map", rounds(calls))
    cs.log(smi)
    print(json.dumps({"ablations_us": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
