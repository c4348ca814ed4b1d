"""Host milliseconds a camera-frame in the tracker's producer thread:
filling the pinned clip buffers and queueing the copies and conversion
(``MultiCameraTracker.timers["stage"]`` over the window)."""

UNIT = "ms"
LAYER = "clip loop (pipeline/multi_cam.py track_clips)"
MOVES = "camera_frames_per_s"
SOURCE = "program_span"
TRACED = True


def read(ctx):
    if not ctx.camera_frames:
        return None
    return ctx.timers["stage"] * 1e3 / ctx.camera_frames
