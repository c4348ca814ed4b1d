"""The whole step's share of the chip's peak: the detector's operations
for every detect frame of the window (all cameras) plus the crop net's for
every crop frame (every crop slot), counted from the layer shapes, over
the window's seconds; each precision's operations against its own peak
(``counts.peaks``), the shares summed."""

from cellbench import counts

UNIT = "%"
LAYER = "the whole step"
MOVES = "camera_frames_per_s"
SOURCE = "host_clock"
TRACED = True


def read(ctx):
    if not ctx.window_s:
        return None
    peaks = counts.peaks(ctx.cfg)
    share = 0.0
    for p in sorted(set(ctx.det_ops) | set(ctx.crop_ops)):
        ops = ctx.branch_frames["detect"] * ctx.det_ops.get(p, 0) + ctx.branch_frames["crop"] * ctx.crop_ops.get(p, 0)
        share += 100.0 * ops / ctx.window_s / peaks[p]
    return share
