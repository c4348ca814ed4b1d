"""Device microseconds a clip of the tracker core's two loops: the NMS
kernels (``csrc/nms.cu``) and the auction (``csrc/auction.cu``)."""

UNIT = "us"
LAYER = "tracker core (ops/nms.py, ops/assignment.py, track/kf.py, pipeline/tracker_state.py)"
MOVES = "camera_frames_per_s"
SOURCE = "device_trace"
TRACED = True

KERNELS = ("fused_kernel", "beats_kernel", "loop_kernel", "shift_kernel", "auction_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.clips:
        return None
    seconds, launches = ctx.trace.kernel_seconds(KERNELS)
    if not launches:
        return None
    return seconds * 1e6 / ctx.clips
