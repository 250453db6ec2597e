"""Device milliseconds per render of the whole map: the timing CUDA events
of `splat.render`'s `render.full` span (recorded on the stream around the
render, never waited on, read after the window) over the counted frames
(`spans.py`).  Such a render has no active window and more rows than the
packed z-buffer key holds: the local loop check's INACTIVE render, and the
inter-map verification's render of the other map.  On the card it is
kernel K3 (`ops/zbuffer.py`), one `zbuffer` launch a render.  Printed
beside it: the `render.full` spans since the recorder started against the
`zbuffer` launches since then (equal where every full render went through
K3).  On a program without the span nothing is read; on the CPU, the
span's host milliseconds."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import spans  # noqa: E402

UNIT = "ms"
LAYER = "kernel K3 (csrc/zbuffer.cu via ops/zbuffer.py)"
MOVES = "frame_ms_p95"
SOURCE = "program_span"


def _launches() -> int:
    from densemonoslam_tpu_torch.utils import launches

    return launches.total("zbuffer")


def install(ctx):
    spans.install(ctx)
    ctx.probes.setdefault("zbuffer_launches0", _launches())


def read(ctx):
    st = spans.state(ctx)
    if st is None:
        return None
    full = [r for r in st["recs"] if r.name == "render.full"]
    if not full:
        return None
    spans.log(f"render.full: {len(full)} spans since the recorder started, zbuffer launches "
              f"{_launches() - ctx.probes['zbuffer_launches0']} since then")
    ms = [st["timer"].device_ms(r) if r.events is not None else (None if ctx.on_card else r.ms)
          for r in spans.spans(st, "render.full")]
    return spans.mean(m for m in ms if m is not None)
