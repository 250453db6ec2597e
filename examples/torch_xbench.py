"""Profiler-based micro-benchmark harness (the PyTorch port's twin of
`examples/xbench.py`).

A host clock around a small call times its launch, not its work: PyTorch
returns before the card finishes.  So every case runs under
`torch.profiler` and reports its per-operation self time on the tensors'
device, read from `key_averages()`: the device self time of each CUDA
kernel, copy and fill on the card; the CPU self time of each operator when
the case's tensors are on the CPU.

Usage:
    from examples.torch_xbench import xbench
    xbench({"name": (fn, args), ...}, iters=10)
"""

from __future__ import annotations

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def _device_of(args) -> torch.device:
    """The device of the first tensor among `args` (nested tuples and
    lists included); the CPU when there is none."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, (tuple, list)):
            dev = _device_of(a)
            if dev.type != "cpu":
                return dev
    return torch.device("cpu")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def op_times(prof, on_card: bool) -> list:
    """[(operation, occurrences, summed self us)] of a profile: the device
    operations on the card (ranges of `record_function` left out), the CPU
    operators on the CPU."""
    out = []
    for row in prof.key_averages():
        if getattr(row, "is_user_annotation", False):
            continue
        if on_card:
            if row.device_type != DeviceType.CUDA:
                continue
            us = row.self_device_time_total
        else:
            if row.device_type != DeviceType.CPU:
                continue
            us = row.self_cpu_time_total
        if us > 0:
            out.append((row.key, int(row.count), float(us)))
    return out


def xbench(cases: dict, iters: int = 10, top: int = 6, quiet: bool = False):
    """Run each case under its own profile; report ms per call per case.

    Each case value is (fn, args_tuple); the device is that of the first
    tensor in args.  Each case is called once before its profile, so a
    kernel's first-use build and cuDNN's set-up stay out of it.  Returns
    {case: ms_per_call}: device self time on the card (NaN where its profile
    holds no device operation), CPU self time on the CPU."""
    for name, (fn, args) in cases.items():
        fn(*args)
        _sync(_device_of(args))

    results = {}
    for name, (fn, args) in cases.items():
        dev = _device_of(args)
        on_card = dev.type == "cuda"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            for _ in range(iters):
                fn(*args)
            _sync(dev)
        ops = op_times(prof, on_card)
        total_us = sum(t for _, _, t in ops)
        # a profile of a case that ran on the card without one device event
        # lost them (CUPTI on some cards drops a window's records): no time
        results[name] = total_us / iters / 1000.0 if ops or not on_card else float("nan")
        if not quiet:
            where = "device" if on_card else "cpu"
            print(f"{name:<40} {results[name]:8.3f} ms/call  ({where})")
            for op, occ, t in sorted(ops, key=lambda o: -o[2])[:top]:
                if t / iters > 20:  # >20us/call
                    print(f"    {op[:66]:<66} {t / iters:8.1f} us")
    return results
