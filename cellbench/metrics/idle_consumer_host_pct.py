"""The share of the program's recorded ``track_clips`` call in which no
kernel, copy or fill ran on the device while the tracker's consumer did its
own host work: enqueueing a clip (``enqueue``) or unpacking one read back
(``drain`` outside its ``drain_wait``). The card starved by the consumer;
the split is ``idle_await_producer_pct``'s."""

from pathlib import Path

from cellbench.manifest import load_reader

UNIT = "%"
LAYER = "clip loop (pipeline/multi_cam.py track_clips)"
MOVES = "camera_frames_per_s"
SOURCE = "program_span"
TRACED = True

_split = load_reader(Path(__file__).with_name("idle_await_producer_pct.py"))


def read(ctx):
    shares = _split.idle_shares(ctx)
    return None if shares is None else shares["consumer_host"]
