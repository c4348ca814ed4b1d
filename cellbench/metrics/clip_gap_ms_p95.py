"""The 95th percentile of the host time between consecutive clip calls
over every clip of the window: a cycle of the tracker's consumer (enqueue
a clip, read back and unpack the clip three behind, wait for the next
staged clip). Stalls show here."""

import numpy as np

UNIT = "ms"
LAYER = "clip loop (pipeline/multi_cam.py track_clips)"
MOVES = "camera_frames_per_s"
SOURCE = "host_clock"
TRACED = True


def read(ctx):
    starts = np.asarray(ctx.clip_starts_ns, np.int64)
    if starts.size < 3:
        return None
    return float(np.percentile(np.diff(starts) / 1e6, 95))
