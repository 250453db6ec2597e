"""The depth CNN's share of the card's float32 peak over the traced span:
its forward operations a frame (`roofline.depthnet_flop` at the camera's
size and the packaged net's widths) times the frames handed over in the
span, over the span's seconds times 67 TFLOP/s (TF32 is off).  The card's
power limit is printed beside it."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import roofline  # noqa: E402

UNIT = "%"
LAYER = "depth CNN (models/depthnet.py)"
MOVES = "fps"
SOURCE = "host_clock"


def read(ctx):
    net = ctx.config.get("depth_net")
    if not net or ctx.span_frames <= 0 or ctx.span_s <= 0:
        return None
    root = os.path.dirname(os.path.abspath(ctx.spec.bench_dir))
    with open(os.path.join(root, "densemonoslam_tpu_torch", "models", "weights",
                           f"depthnet_{net}.json")) as f:
        widths = json.load(f)["widths"]
    cam = ctx.config["camera"]
    flop = roofline.depthnet_flop(int(cam["height"]), int(cam["width"]), widths)
    return 100.0 * flop * ctx.span_frames / (ctx.span_s * roofline.PEAK_F32_S)
