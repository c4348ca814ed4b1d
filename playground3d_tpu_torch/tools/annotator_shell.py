"""Interactive / scriptable annotation review shell.

A numpy copy of ``playground3d_tpu/tools/annotator_shell.py`` with its imports pointed
at the port's modules.

The reference's manual annotator is an OpenCV GUI loop
(manual_annotator_state_v3.py:2865 ``run``) whose workflow is documented as
keybindings in the reference README.md:1-16. This shell provides the same
workflow without a GUI stack: it steps frames, renders overlay PNGs, and
applies the :class:`AnnotationSession` label operations through text
commands — usable interactively (stdin) or scripted (command list / file),
which also makes the whole workflow testable.

Keybinding -> command parity (reference README.md:1-16):

  ``8``/``9``, ``-``/``+``   -> ``next [n]`` / ``prev [n]``
  ``[``/``]``                -> ``cam next|prev|<name>``
  ``a`` (new box)            -> ``add <x> <y> [class]``
  ``r`` (delete onward)      -> ``delete <id>``
  ``s`` (shift x/y)          -> ``shift <id> <dx> <dy>``
  ``d`` (dimension edit)     -> ``dim <id> <dl> <dw> <dh>``
  ``c`` (copy/paste)         -> ``copy <id>`` then ``paste``
  ``v`` (class edit)         -> ``class <id> <name|id>``
  ``u`` (undo)               -> ``undo``
  ``w`` / ``q``              -> ``save [path]`` / ``quit``
  (plus: ``interp``, ``outliers``, ``auto``, ``render``, ``show``, ``goto``)
"""

from __future__ import annotations

import copy
import shlex
import sys
from typing import Callable, Iterable, List, Optional

import numpy as np

from playground3d_tpu_torch.evaluation.csv_io import (
    TrackRecord,
    load_i24_csv,
    parse_state_row,
    write_results_csv,
)
from playground3d_tpu_torch.tools.annotator import AnnotationSession
from playground3d_tpu_torch.utils.constants import CLASS_NAMES

FPS = 30.0


def session_from_csv(path: str) -> AnnotationSession:
    """Load a 46-column tracking CSV into an AnnotationSession (state rows)."""
    _, data = load_i24_csv(path)
    sess = AnnotationSession()
    name_to_id = {n: i for i, n in enumerate(CLASS_NAMES)}
    for frame in sorted(data.keys()):
        for row in data[frame]:
            try:
                state7 = parse_state_row(row)
                t = float(row[1])
                oid = int(float(row[2]))
            except (ValueError, IndexError):
                continue
            cls = name_to_id.get(row[3].strip(), 0)
            sess.add_box(t, state7, cls, oid)
    return sess


def session_to_records(
    sess: AnnotationSession, registry=None, camera: Optional[str] = None
) -> List[TrackRecord]:
    """AnnotationSession -> TrackRecords (projected through the camera when a
    registry is given; zero image corners otherwise)."""
    from playground3d_tpu_torch.evaluation import geometry_np as G

    out = []
    t0 = min((l.t for ls in sess.labels.values() for l in ls), default=0.0)
    for oid, ls in sess.labels.items():
        for l in ls:
            space = G.state_to_space(l.state7[None])
            if registry is not None and camera is not None:
                c = registry.index(camera)
                im = G.space_to_im(space, registry.P[c, 0])[0]
            else:
                im = np.zeros((8, 2))
            out.append(
                TrackRecord(
                    frame=int(round((l.t - t0) * FPS)),
                    timestamp=l.t,
                    obj_id=oid,
                    class_name=CLASS_NAMES[int(l.class_id)],
                    state7=l.state7,
                    im_corners=im,
                    space_footprint=space[0, 0:4, :2],
                    camera=camera or "p1c1",
                )
            )
    out.sort(key=lambda r: (r.frame, r.obj_id))
    return out


class AnnotatorShell:
    """Frame-stepping review shell over an AnnotationSession.

    Parameters
    ----------
    session : the label store
    registry / cameras : camera geometry for rendering + projection
    frames : optional callable (frame_idx, camera) -> [H,W,3] image for
        overlay rendering; without it ``render`` draws on a black canvas
    t0 : absolute time of frame 0; frame i is at t0 + i/30
    detector : optional callable (t, camera) -> (states [n,>=6], classes [n])
        for ``auto`` labeling (the reference's crop-detector assist, v3:644)
    out : stream for messages (stdout by default)
    """

    def __init__(
        self,
        session: AnnotationSession,
        registry=None,
        cameras: Optional[List[str]] = None,
        frames: Optional[Callable] = None,
        t0: Optional[float] = None,
        detector: Optional[Callable] = None,
        out=None,
    ):
        self.sess = session
        self.registry = registry
        self.cameras = cameras or (registry.names if registry is not None else ["p1c1"])
        self.cam_i = 0
        self.frames = frames
        if t0 is None:
            t0 = min(
                (l.t for ls in session.labels.values() for l in ls), default=0.0
            )
        self.t0 = float(t0)
        self.frame = 0
        self.detector = detector
        self.out = out or sys.stdout
        self._undo: Optional[dict] = None
        self._copied: Optional[int] = None
        self.done = False
        self.save_path: Optional[str] = None

    # -- helpers ---------------------------------------------------------------
    @property
    def t(self) -> float:
        return self.t0 + self.frame / FPS

    @property
    def camera(self) -> str:
        return self.cameras[self.cam_i]

    def _say(self, msg: str) -> None:
        print(msg, file=self.out)

    def _snapshot(self) -> None:
        self._undo = copy.deepcopy(self.sess.labels)

    def _labels_at(self, tol: float = 1 / (2 * FPS)):
        for oid, ls in self.sess.labels.items():
            for l in ls:
                if abs(l.t - self.t) < tol:
                    yield oid, l

    # -- command handlers --------------------------------------------------------
    def cmd_next(self, n: str = "1"):
        self.frame += int(n)

    def cmd_prev(self, n: str = "1"):
        self.frame = max(0, self.frame - int(n))

    def cmd_goto(self, n: str):
        self.frame = max(0, int(n))

    def cmd_cam(self, which: str):
        if which == "next":
            self.cam_i = (self.cam_i + 1) % len(self.cameras)
        elif which == "prev":
            self.cam_i = (self.cam_i - 1) % len(self.cameras)
        else:
            self.cam_i = self.cameras.index(which)
        self._say(f"camera {self.camera}")

    def cmd_add(self, x: str, y: str, cls: str = "0"):
        self._snapshot()
        cid = self._class_id(cls)
        state7 = np.array(
            [float(x), float(y), 18.0, 6.0, 5.0, 1.0 if float(y) <= 60 else -1.0, 0.0]
        )
        oid = self.sess.add_box(self.t, state7, cid)
        self._say(f"added object {oid} at frame {self.frame}")

    def cmd_delete(self, oid: str):
        """Delete the object from the current frame ONWARD (reference `r`)."""
        self._snapshot()
        oid = int(oid)
        before = len(self.sess.labels.get(oid, []))
        self.sess.labels[oid] = [
            l for l in self.sess.labels.get(oid, []) if l.t < self.t - 1e-6
        ]
        self._say(f"deleted {before - len(self.sess.labels[oid])} labels of {oid}")

    def cmd_shift(self, oid: str, dx: str, dy: str):
        self._snapshot()
        self.sess.shift(int(oid), self.t, float(dx), float(dy))

    def cmd_dim(self, oid: str, dl: str, dw: str, dh: str = "0"):
        """Dimension edit applies to ALL frames of the object (reference `d`)."""
        self._snapshot()
        for l in self.sess.labels[int(oid)]:
            l.state7[2] += float(dl)
            l.state7[3] += float(dw)
            l.state7[4] += float(dh)

    def cmd_copy(self, oid: str):
        self._copied = int(oid)
        self._say(f"copied {oid}")

    def cmd_paste(self):
        """Paste the copied object's nearest label into the current frame with
        constant-velocity rollforward (reference `c`)."""
        assert self._copied is not None, "copy first"
        self._snapshot()
        ls = self.sess.labels[self._copied]
        src_t = min((l.t for l in ls), key=lambda t: abs(t - self.t))
        self.sess.paste_forward(self._copied, src_t, self.t)
        self._say(f"pasted {self._copied} at frame {self.frame}")

    def cmd_class(self, oid: str, cls: str):
        self._snapshot()
        self.sess.set_class(int(oid), self._class_id(cls))

    def cmd_interp(self, oid: str):
        self._snapshot()
        self.sess.interpolate(int(oid), hz=FPS)

    def cmd_outliers(self, oid: str, sigma: str = "3.0"):
        self._snapshot()
        n = self.sess.remove_outliers(int(oid), sigma=float(sigma))
        self._say(f"removed {n} outliers from {oid}")

    def cmd_auto(self):
        """Detector-assisted labeling of the current frame (reference
        `automate`, v3:644)."""
        assert self.detector is not None, "no detector attached"
        self._snapshot()
        states, classes = self.detector(self.t, self.camera)
        ids = self.sess.auto_label(np.asarray(states), np.asarray(classes), self.t)
        self._say(f"auto-labeled {len(ids)} objects: {sorted(set(ids))}")

    def cmd_undo(self):
        if self._undo is None:
            self._say("nothing to undo")
            return
        self.sess.labels = self._undo
        self._undo = None
        self._say("undone")

    def cmd_show(self):
        rows = sorted(self._labels_at(), key=lambda p: p[0])
        self._say(f"frame {self.frame} (t={self.t:.3f}) camera {self.camera}: {len(rows)} labels")
        for oid, l in rows:
            s = l.state7
            self._say(
                f"  id {oid} {CLASS_NAMES[int(l.class_id)]} x={s[0]:.1f} y={s[1]:.1f} "
                f"lwh=({s[2]:.1f},{s[3]:.1f},{s[4]:.1f}) d={int(s[5])} v={s[6]:.1f}"
            )

    def cmd_render(self, path: str, height: str = "1080", width: str = "1920"):
        """Render the current frame's labels as an overlay PNG (the GUI view,
        headless)."""
        from playground3d_tpu_torch.data.video import write_png
        from playground3d_tpu_torch.evaluation import geometry_np as G
        from playground3d_tpu_torch.tools.visualize import plot_boxes

        h, w = int(height), int(width)
        if self.frames is not None:
            frame = np.asarray(self.frames(self.frame, self.camera), np.float32)
        else:
            frame = np.zeros((h, w, 3), np.float32)
        pairs = list(self._labels_at())
        if pairs and self.registry is not None:
            states = np.stack([l.state7 for _, l in pairs])
            c = self.registry.index(self.camera)
            space = G.state_to_space(states)
            im = G.space_to_im(space, self.registry.P[c, 0])
            frame = plot_boxes(
                frame, im, labels=[str(oid) for oid, _ in pairs]
            )
        write_png(path, frame)
        self._say(f"rendered frame {self.frame} -> {path}")

    def cmd_save(self, path: Optional[str] = None):
        path = path or self.save_path
        assert path, "no save path"
        self.save_path = path
        if path.endswith(".npz"):
            self.sess.save(path)
        else:
            write_results_csv(
                path, session_to_records(self.sess, self.registry, self.camera)
            )
        self._say(f"saved -> {path}")

    def cmd_quit(self):
        if self.save_path:
            self.cmd_save()
        self.done = True

    def cmd_help(self):
        cmds = sorted(m[4:] for m in dir(self) if m.startswith("cmd_"))
        self._say("commands: " + " ".join(cmds))

    # -- dispatch ----------------------------------------------------------------
    def _class_id(self, cls: str) -> int:
        if cls.isdigit():
            return int(cls)
        return list(CLASS_NAMES).index(cls)

    def execute(self, line: str) -> None:
        parts = shlex.split(line.strip())
        if not parts or parts[0].startswith("#"):
            return
        name, args = parts[0], parts[1:]
        fn = getattr(self, f"cmd_{name}", None)
        if fn is None:
            self._say(f"unknown command: {name} (try 'help')")
            return
        fn(*args)

    def run(self, commands: Optional[Iterable[str]] = None) -> None:
        """Drive from an iterable of command lines, or interactively from
        stdin when None."""
        if commands is None:
            commands = iter(sys.stdin.readline, "")
        for line in commands:
            if self.done:
                break
            try:
                self.execute(line)
            except Exception as e:  # keep the review session alive on typos
                self._say(f"error: {e}")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="annotation review shell")
    p.add_argument("csv", help="46-column tracking CSV (or .npz session)")
    p.add_argument("--save", default=None, help="save path (csv or npz)")
    p.add_argument("--script", default=None, help="command file to execute")
    args = p.parse_args(argv)

    if args.csv.endswith(".npz"):
        sess = AnnotationSession.load(args.csv)
    else:
        sess = session_from_csv(args.csv)
    shell = AnnotatorShell(sess)
    shell.save_path = args.save or args.csv
    if args.script:
        with open(args.script) as f:
            shell.run(f)
    else:
        shell.cmd_help()
        shell.run()


if __name__ == "__main__":
    main()
