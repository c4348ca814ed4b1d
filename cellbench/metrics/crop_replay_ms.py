"""The crop frame's captured graph replayed alone after the window, CUDA
events, median of 5."""

UNIT = "ms"
LAYER = "branch graphs (pipeline/graphs.py, make_mc_clip_step)"
MOVES = "camera_frames_per_s"
SOURCE = "device_trace"
TRACED = True


def read(ctx):
    return ctx.replay_ms.get("crop")
