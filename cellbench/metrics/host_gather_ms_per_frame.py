"""Host milliseconds a camera-frame in the tracker's producer thread
pulling the cameras' frames from their sources (sync skips included) and
stacking them into one array: the program's ``source`` and ``stack`` spans
(``MultiCameraTracker.timers``) over the window."""

UNIT = "ms"
LAYER = "clip loop (pipeline/multi_cam.py track_clips)"
MOVES = "camera_frames_per_s"
SOURCE = "program_span"
TRACED = True


def read(ctx):
    if not ctx.camera_frames or "source" not in ctx.timers or "stack" not in ctx.timers:
        return None  # a program without these spans
    return (ctx.timers["source"] + ctx.timers["stack"]) * 1e3 / ctx.camera_frames
