"""The whole step's share of the chip's peak: the detector's operations
for every detect frame of the window (all cameras) plus the crop net's for
every crop frame (every crop slot), counted from the layer shapes, over
the window's seconds, against the configuration's peak."""

UNIT = "%"
LAYER = "the whole step"
MOVES = "camera_frames_per_s"
SOURCE = "host_clock"
TRACED = True


def read(ctx):
    if not ctx.window_s:
        return None
    ops = ctx.branch_frames["detect"] * ctx.det_ops + ctx.branch_frames["crop"] * ctx.crop_ops
    return 100.0 * ops / ctx.window_s / ctx.cfg["peak_ops_per_s"]
