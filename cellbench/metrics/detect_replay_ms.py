"""A detect frame's captured graphs replayed alone after the window: the
camera shard's forward and top-k (``frame``) and the lead's merge, NMS
and parse (``detect``), CUDA events, median of 5 each, summed."""

UNIT = "ms"
LAYER = "branch graphs (pipeline/graphs.py, make_mc_clip_step)"
MOVES = "camera_frames_per_s"
SOURCE = "device_trace"
TRACED = True


def read(ctx):
    replay = ctx.replay_ms
    if "frame" not in replay or "detect" not in replay:
        return None
    return replay["frame"] + replay["detect"]
