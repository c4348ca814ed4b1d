"""Headless visualization: 3D box overlays and roadway-plane plots (numpy
copy of ``playground3d_tpu/tools/visualize.py``).

The reference plots with cv2 windows (homography.py:670-714 ``plot_boxes``,
trackers' live overlays). Without a display or cv2 this renders overlays
directly into numpy frames (line rasterization) and writes PNGs, with an
optional matplotlib backend for roadway ("bird's eye") plots: matplotlib is
imported only inside :func:`birdseye_plot`, so a machine without it runs
everything else. :class:`TrackOverlayWriter` takes the port's snapshots,
whose fields may be tensors on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# edges of the 3D box in the 8-corner order fbr,fbl,bbr,bbl,ftr,ftl,btr,btl
BOX_EDGES = [
    (0, 1), (2, 3), (0, 2), (1, 3),  # bottom face
    (4, 5), (6, 7), (4, 6), (5, 7),  # top face
    (0, 4), (1, 5), (2, 6), (3, 7),  # verticals
]


def draw_line(frame: np.ndarray, p0, p1, color, thickness: int = 1) -> None:
    """Bresenham-ish line into [H,W,3] float frame (in place)."""
    h, w = frame.shape[:2]
    x0, y0, x1, y1 = float(p0[0]), float(p0[1]), float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.linspace(x0, x1, n)
    ys = np.linspace(y0, y1, n)
    for t in range(-(thickness // 2), thickness - thickness // 2):
        xi = np.round(xs).astype(int)
        yi = np.round(ys + t).astype(int)
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        frame[yi[ok], xi[ok]] = color


def plot_boxes(
    frame: np.ndarray,
    boxes: np.ndarray,
    color=(1.0, 1.0, 1.0),
    thickness: int = 1,
    labels: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """Draw [d,8,2] image-space 3D boxes (reference plot_boxes,
    homography.py:670-714). Returns the frame (copy)."""
    out = frame.copy()
    color = np.asarray(color, out.dtype)
    for d in range(len(boxes)):
        b = boxes[d]
        if not np.isfinite(b).all():
            continue
        for a, c in BOX_EDGES:
            draw_line(out, b[a], b[c], color, thickness)
    return out


def birdseye_plot(
    states: np.ndarray,
    x_range: Tuple[float, float],
    path: Optional[str] = None,
    ids: Optional[Sequence[int]] = None,
):
    """Roadway-plane footprint plot via matplotlib (agg backend)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from playground3d_tpu_torch.evaluation import geometry_np as G

    fig, ax = plt.subplots(figsize=(12, 3))
    if len(states):
        space = G.state_to_space(states)
        for i in range(len(states)):
            fp = space[i, [0, 1, 3, 2, 0], :2]
            ax.plot(fp[:, 0], fp[:, 1], "-")
            if ids is not None:
                ax.annotate(str(ids[i]), (states[i, 0], states[i, 1]))
    ax.set_xlim(*x_range)
    ax.set_ylim(-10, 130)
    ax.axhline(60, color="gray", ls="--", lw=0.5)
    ax.set_xlabel("roadway x (ft)")
    ax.set_ylabel("y (ft)")
    if path:
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig


def _host(x) -> np.ndarray:
    """A snapshot field (a tensor on any device, or an array) as numpy."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _depth_to_space(x: np.ndarray, block: int = 4) -> np.ndarray:
    """Inverse of models.resnet.space_to_depth (and ops.crop_mxu.pack_s2d)
    for one [h,w,C*b*b] frame."""
    h, w, cbb = x.shape
    c = cbb // (block * block)
    x = x.reshape(h, w, block, block, c)
    x = x.transpose(0, 2, 1, 3, 4)
    return x.reshape(h * block, w * block, c)


class TrackOverlayWriter:
    """Per-frame tracking observability — the reference's live overlay loop
    (MC3D_crop_tracker.py:733-917 plots priors, posteriors and per-camera
    state onto each camera view) rendered headlessly: posterior 3D boxes
    (green) and constant-velocity-rolled priors from the previous snapshot
    (blue) per camera, plus a clock-bias tint patch (red = camera ahead,
    blue = behind), written as PNGs through
    :class:`playground3d_tpu_torch.data.video.AsyncFrameWriter` (one subdirectory
    per camera; frames stay in submission order).

    Pass as ``on_frame=`` to :class:`SingleCameraTracker` /
    :class:`MultiCameraTracker`; call :meth:`close` to flush.
    """

    def __init__(
        self,
        registry,
        cameras: Sequence[str],
        out_dir: str,
        every: int = 1,
        prior_color=(0.25, 0.45, 1.0),
        posterior_color=(0.2, 1.0, 0.3),
    ):
        import os

        from playground3d_tpu_torch.data.video import AsyncFrameWriter

        self.registry = registry
        self.cameras = list(cameras)
        self.rows = [registry.index(c) for c in self.cameras]
        self.every = max(1, int(every))
        self.prior_color = prior_color
        self.posterior_color = posterior_color
        self.writers = [
            AsyncFrameWriter(os.path.join(out_dir, c)) for c in self.cameras
        ]
        self._prev: Optional[Tuple[float, np.ndarray, np.ndarray]] = None
        self.frames_written = 0

    @staticmethod
    def _displayable(frame: np.ndarray) -> np.ndarray:
        """[H,W,3] of any transport dtype -> float RGB in [0,1]; unpacks
        s2d-packed [h,w,48] frames."""
        frame = np.asarray(frame)
        if frame.shape[-1] == 48:
            frame = _depth_to_space(frame)
        frame = frame.astype(np.float32)
        if frame.max() > 2.0:  # uint8-range transport
            return frame / 255.0
        if frame.min() < -0.5:  # ImageNet-normalized transport
            from playground3d_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD

            return np.clip(
                frame * np.asarray(IMAGENET_STD) + np.asarray(IMAGENET_MEAN), 0, 1
            )
        return np.clip(frame, 0, 1)

    def _im_boxes(self, states: np.ndarray, cam_row: int) -> np.ndarray:
        """[n,7] states -> [n,8,2] image-space boxes through the camera's
        y-split projection bank (same dispatch as the tracker observes)."""
        from playground3d_tpu_torch.evaluation import geometry_np as G

        return G.state_to_im_banked(
            states, self.registry.P[cam_row, 0], self.registry.P[cam_row, 1]
        )

    def __call__(self, frame_num: int, frames: np.ndarray, snap, ts_bias=None):
        if frame_num % self.every:
            return
        states = _host(snap.states7)
        mask = _host(snap.raw_mask)
        t = float(_host(snap.t))
        live = states[mask]

        # priors: the previous posterior rolled forward at its own velocity
        # (what the tracker predicted before this frame's measurements)
        prior = None
        if self._prev is not None:
            tp, sp = self._prev
            dt = t - tp
            prior = sp.copy()
            prior[:, 0] = prior[:, 0] + prior[:, 5] * prior[:, 6] * dt
        self._prev = (t, live.copy())

        frames = _host(frames)
        if frames.ndim == 3:
            frames = frames[None]
        for ci, (row, writer) in enumerate(zip(self.rows, self.writers)):
            canvas = self._displayable(frames[ci])
            if prior is not None and len(prior):
                canvas = plot_boxes(
                    canvas, self._im_boxes(prior, row), color=self.prior_color
                )
            if len(live):
                canvas = plot_boxes(
                    canvas, self._im_boxes(live, row), color=self.posterior_color
                )
            if ts_bias is not None:
                b = float(_host(ts_bias).reshape(-1)[ci])
                # +-33ms (one frame) full-scale tint patch
                s = float(np.clip(b / 0.033, -1.0, 1.0))
                patch = np.array(
                    [0.5 + 0.5 * max(s, 0.0), 0.15, 0.5 + 0.5 * max(-s, 0.0)],
                    np.float32,
                )
                canvas[:8, :8] = patch
            writer(canvas)
        self.frames_written += 1

    def close(self, timeout: float = 60.0) -> None:
        for w in self.writers:
            w.close(timeout=timeout)


def frames_dir_to_video(
    frames_dir: str, out_path: str, fps: int = 30, subsample: bool = True
) -> int:
    """Assemble a directory of numbered PNG frames (what TrackOverlayWriter /
    AsyncFrameWriter emit) into a video — the reference's ``im_to_vid``
    overlay-to-video workflow (minimal_3D_track.py:920-937,
    cv2.VideoWriter there). An ``.mp4`` out_path encodes real H.264/MPEG-4
    through the first-party libav shim when available; any other extension
    writes dependency-free YUV4MPEG2.

    Returns the number of frames written.
    """
    import os

    from playground3d_tpu_torch.data.video import read_png, write_y4m

    names = sorted(n for n in os.listdir(frames_dir) if n.endswith(".png"))
    if not names:
        raise ValueError(f"no .png frames in {frames_dir}")

    def frames():
        for n in names:
            f = read_png(os.path.join(frames_dir, n))
            yield f if f.dtype == np.uint8 else np.clip(f, 0, 255).astype(np.uint8)

    if out_path.endswith(".mp4"):
        from playground3d_tpu_torch.data import avdecode

        if not avdecode.available():
            raise RuntimeError(
                "mp4 export needs the libav shim (data/avdecode.py, built where "
                "the FFmpeg libraries are found); "
                "use a .y4m out_path for the dependency-free writer"
            )
        it = frames()
        first = next(it)
        h, w = first.shape[:2]
        with avdecode.AvWriter(out_path, w, h, fps=fps) as wtr:
            wtr.add(first)
            for f in it:
                wtr.add(f)
        return len(names)

    write_y4m(out_path, frames(), fps=fps, subsample=subsample)
    return len(names)
