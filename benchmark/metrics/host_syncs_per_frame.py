"""Synchronising calls per frame over the traced span: the warnings of
`torch.cuda.set_sync_debug_mode("warn")` (each a call on which the host
waited for the card), divided by the frames handed over in the span."""

UNIT = "syncs/frame"
LAYER = "engine (engine.py Engine.process_frame)"
MOVES = "fps"
SOURCE = "program_counter"


def read(ctx):
    if ctx.span_frames <= 0:
        return None
    return ctx.syncs / ctx.span_frames
