"""The crop's share of its roofline: the bytes the window's crop frames
need (the pixels under each live track's box read once, its crop written
once), counted over every crop frame of the window from the rows read
back, over 3.35 TB/s, over the device time of the kernels the
configuration's ``crop_kernels`` lists."""

from cellbench import counts

UNIT = "%"
LAYER = "crop kernels (ops/crop_mxu.py, ops/crop_resize.py, csrc/crop_resize*.cu)"
MOVES = "camera_frames_per_s"
SOURCE = "device_trace"
TRACED = True


def read(ctx):
    if ctx.trace is None or not sum(ctx.crop_bytes):  # no live track at any crop frame: nothing to read
        return None
    seconds, _ = ctx.trace.kernel_seconds(ctx.cfg["crop_kernels"])
    if seconds <= 0:
        return None
    return 100.0 * sum(ctx.crop_bytes) / counts.HBM_BYTES_PER_S / seconds
