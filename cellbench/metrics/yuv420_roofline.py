"""The YUV420 conversion's share of its roofline: the planar bytes read and
the RGB bytes written for every camera-frame of the window over 3.35 TB/s,
over the device time of ``yuv420_s2d_kernel``."""

from cellbench import counts

UNIT = "%"
LAYER = "frame transport (ops/yuv420.py + csrc/yuv420_s2d.cu)"
MOVES = "camera_frames_per_s"
SOURCE = "device_trace"
TRACED = True


def read(ctx):
    if ctx.trace is None or ctx.traffic["format"] != "yuv420":
        return None
    seconds, _ = ctx.trace.kernel_seconds(["yuv420_s2d_kernel"])
    if seconds <= 0:
        return None
    nbytes = counts.yuv420_bytes(ctx.camera_frames, ctx.traffic["height"], ctx.traffic["width"])
    return 100.0 * nbytes / counts.HBM_BYTES_PER_S / seconds
