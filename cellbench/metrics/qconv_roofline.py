"""The int8 convolutions' share of their roofline: for every ``qconv``
launch of the window (each detect frame's and crop frame's launches, their
shapes as the reference's own quantized nets make them), the larger of its operations over 1,979 TOP/s and its bytes
over 3.35 TB/s, summed, over the device time of ``qconv_kernel`` in the
trace."""

from cellbench import counts

UNIT = "%"
LAYER = "detector and crop net (models/, ops/qconv.py + csrc/qconv.cu)"
MOVES = "camera_frames_per_s"
SOURCE = "device_trace"
TRACED = True


def read(ctx):
    frames = ctx.qconv_frames
    if ctx.trace is None or not frames.get("detect"):
        return None
    seconds, _ = ctx.trace.kernel_seconds(["qconv_kernel"])
    if seconds <= 0:
        return None
    bound = ctx.branch_frames["crop"] * counts.qconv_bound_s(frames.get("crop", []))
    bound += ctx.branch_frames["detect"] * counts.qconv_bound_s(frames["detect"])
    return 100.0 * bound / seconds
