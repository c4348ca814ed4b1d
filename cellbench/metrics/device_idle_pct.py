"""The share of the window in which no kernel, copy or fill ran on any
stream of the device (profiler, CUDA activity)."""

UNIT = "%"
LAYER = "device (one H100)"
MOVES = "camera_frames_per_s"
SOURCE = "device_trace"
TRACED = True


def read(ctx):
    if ctx.trace is None or not ctx.trace.events:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.window_s)
