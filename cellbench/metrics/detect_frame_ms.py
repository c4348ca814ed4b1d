"""Device milliseconds of a detect frame inside the window: the program's
CUDA events around each replay of the shard's ``frame`` graph (forward and
top-k) and the lead's ``detect`` graph (merge, NMS, parse), summed over the
window, over its detect frames. The in-window counterpart of
``detect_replay_ms``, beside the staging copies and the YUV conversion."""

UNIT = "ms"
LAYER = "branch graphs (pipeline/graphs.py, make_mc_clip_step)"
MOVES = "camera_frames_per_s"
SOURCE = "program_span"
TRACED = True


def read(ctx):
    try:
        from playground3d_tpu_torch.utils.profiling import Spans
    except ImportError:
        return None  # a program without spans
    timed = [s for s in Spans.log if s.device_ms is not None]
    detect = [s.device_ms for s in timed if s.name == "replay.detect"]
    if not detect:
        return None
    return (sum(s.device_ms for s in timed if s.name == "replay.frame") + sum(detect)) / len(detect)
