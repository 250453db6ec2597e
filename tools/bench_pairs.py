"""Two of `torch_bench.py`'s comparisons in alternating pairs on one NVIDIA
GPU: the open loop against relocalisation mode (`bench.py`'s "< 10 %"
overhead) and the 1<<20-row map against the 1<<25-row one (frame cost
against capacity).  One run of a leg is host noise as much as anything
(on an H100 the open-loop leg has read 4.7 to 10.4 fps across runs), so
each comparison runs `--pairs` pairs, alternating which side runs first, at `torch_bench`'s
configuration and 30 timed frames, and prints every run's fps, each side's
median and the spread between its quartiles, and the pairs each side won;
then one more leg of each side under CUDA's sync-debug mode: its host syncs
by source line.

    python3 tools/bench_pairs.py [--pairs 5]

Needs a CUDA card; prints one `[pairs]` line per run, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_bench as tb  # noqa: E402

FRAMES = 30  # timed frames a leg: torch_bench's BENCH_FRAMES default
HEADLINE = dict(open_loop=True)
COMPARISONS = {
    "relocalisation": (HEADLINE, dict(open_loop=True, relocalisation=True)),
    "capacity 1<<25": (HEADLINE, dict(open_loop=True, max_surfels=1 << 25)),
}


def _leg(cfg_kw: dict) -> tuple[float, float]:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    fps, ate_mm, *_ = tb._run_slam(640, 480, FRAMES, 4, cfg_kw, device="cuda")
    return fps, ate_mm


def _sync_sites(cfg_kw: dict) -> tuple[int, dict]:
    """One more leg under CUDA's sync-debug mode (untimed): the host syncs
    of the whole leg (warm-up, timed frames, the trajectory read) and their
    source lines."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _leg(cfg_kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites: dict = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sum(sites.values()), dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def _spread(xs: list) -> float:
    q = np.percentile(xs, [25, 75])
    return float(q[1] - q[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    out = {}
    for name, (base, other) in COMPARISONS.items():
        runs = {"base": [], "other": []}
        ates = {"base": set(), "other": set()}
        wins = 0
        for p in range(args.pairs):
            order = ("base", "other") if p % 2 == 0 else ("other", "base")
            pair = {}
            for side in order:
                fps, ate = _leg(base if side == "base" else other)
                pair[side] = fps
                runs[side].append(fps)
                ates[side].add(round(ate, 6))
                print(f"[pairs] {name} pair {p} {side}: {fps:.3f} fps, ATE {ate:.6f} mm",
                      flush=True)
            wins += pair["base"] > pair["other"]
        med = {k: statistics.median(v) for k, v in runs.items()}
        out[name] = dict(
            base_fps=runs["base"], other_fps=runs["other"], base_median=med["base"],
            other_median=med["other"], base_spread=_spread(runs["base"]),
            other_spread=_spread(runs["other"]),
            overhead_pct=100.0 * (1.0 - med["other"] / med["base"]),
            base_won=wins, pairs=args.pairs, ate_mm={k: sorted(v) for k, v in ates.items()},
        )
        for side, cfg_kw in (("base", base), ("other", other)):
            n, sites = _sync_sites(cfg_kw)
            out[name][f"{side}_syncs"] = n
            print(f"[pairs] {name} {side}: {n} host syncs over the leg's {FRAMES + 4} "
                  f"frames; by source line {sites}", flush=True)
        print(f"[pairs] {name}: median {med['base']:.3f} fps (open loop, 1<<20) against "
              f"{med['other']:.3f}, overhead {out[name]['overhead_pct']:.1f}%, quartile "
              f"spreads {out[name]['base_spread']:.3f} / {out[name]['other_spread']:.3f} fps, "
              f"the open loop faster in {wins} of {args.pairs} pairs", flush=True)
    print(json.dumps({"card": smi, "comparisons": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
