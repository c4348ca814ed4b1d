"""Detection training datasets and the host-side batch pipeline (port of
``playground3d_tpu/data/dataset.py``).

* :class:`SyntheticDetectionDataset` renders frames + 21-value labels from
  :class:`~playground3d_tpu_torch.data.synthetic.SyntheticScene` on the fly
  (full-frame mode) or object-centered square crops (crop mode, the crop
  detector's dataset, corrected_3D_dataset.py:501-594);
* :class:`CachedDetectionDataset` reads frames + labels from .npz shards
  (the reference's frame cache, corrected_3D_dataset.py:24-123);
* the augmentations: photometric jitter, horizontal flip with the left/right
  corner-order swap, scale/aspect, rotation and 2x2 tile shuffle
  (corrected_3D_dataset.py:331-492);
* :class:`Prefetcher`, background threads that build batches ahead of the
  train step and stage them on a device: a copy into pinned memory, then a
  ``non_blocking`` copy to the device the caller names.

Numpy on the host; each function draws from its ``rng`` in the JAX
module's order, so a seed gives both packages the same samples.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from playground3d_tpu_torch import DeviceLike, resolve_device
from playground3d_tpu_torch.data.synthetic import SyntheticScene, render_frame
from playground3d_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD

MAX_OBJS = 32


def pad_labels(labels: np.ndarray, max_objs: int = MAX_OBJS) -> np.ndarray:
    """Pad [m,21] to [max_objs,21] with class -1 rows (the reference's
    collate padding, corrected_3D_dataset.py:714-741)."""
    out = np.full((max_objs, 21), -1.0, np.float32)
    m = min(len(labels), max_objs)
    if m:
        out[:m] = labels[:m]
    return out


def hflip(frame: np.ndarray, labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontal flip with the L/R corner-order swap
    (corrected_3D_dataset.py:350-364): mirroring x swaps which physical side
    is 'left', so corner pairs (0,1),(2,3),(4,5),(6,7) exchange."""
    w = frame.shape[1]
    frame = frame[:, ::-1].copy()
    labels = labels.copy()
    valid = labels[:, 20] >= 0
    xs = labels[:, 0:16:2]
    xs[valid] = w - 1 - xs[valid]
    labels[:, 0:16:2] = xs
    # swap corner pairs to restore the sign convention
    corners = labels[:, :16].reshape(-1, 8, 2)
    corners = corners[:, [1, 0, 3, 2, 5, 4, 7, 6], :]
    labels[:, :16] = corners.reshape(-1, 16)
    x1 = labels[:, 16].copy()
    labels[valid, 16] = w - 1 - labels[valid, 18]
    labels[valid, 18] = w - 1 - x1[valid]
    return frame, labels


def photometric_jitter(frame: np.ndarray, rng: np.random.Generator, strength=0.2):
    """Brightness/contrast jitter in normalized space (stand-in for the
    reference's ColorJitter, corrected_3D_dataset.py:177-190)."""
    scale = 1.0 + rng.uniform(-strength, strength)
    shift = rng.uniform(-strength, strength)
    return frame * scale + shift


def scale_aspect(
    frame: np.ndarray, labels: np.ndarray, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Random scale/aspect stretch pasted back onto a noise canvas of the
    original size (reference corrected_3D_dataset.py:331-347): scale ~
    max(1, N(1,0.1)) on x, scale*aspect with aspect ~ max(0.75, N(1,0.2))
    on y; labels scale accordingly; objects pushed fully outside drop."""
    h, w = frame.shape[:2]
    scale = max(1.0, float(rng.normal(1.0, 0.1)))
    aspect = max(0.75, float(rng.normal(1.0, 0.2)))
    nh, nw = max(int(h * scale * aspect), 1), max(int(w * scale), 1)
    from playground3d_tpu_torch.data.video import resize_frame

    resized = resize_frame(frame.astype(np.float32), (nh, nw))
    lo, hi = float(frame.min()), float(frame.max())
    canvas = rng.uniform(lo, hi, (h, w, frame.shape[2])).astype(np.float32)
    canvas[: min(nh, h), : min(nw, w)] = resized[:h, :w]

    labels = labels.copy()
    valid = labels[:, 20] >= 0
    labels[valid, 0:20:2] *= scale
    labels[valid, 1:20:2] *= scale * aspect
    # drop objects whose 2D box no longer intersects the canvas
    keep = ~valid | (
        (labels[:, 16] < w) & (labels[:, 18] >= 0) & (labels[:, 17] < h) & (labels[:, 19] >= 0)
    )
    return canvas, labels[keep]


def rotate(frame: np.ndarray, labels: np.ndarray, angle_deg: float) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate the image about its center and re-project all label
    coordinates (reference corrected_3D_dataset.py:367-391)."""
    h, w = frame.shape[:2]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    th = np.deg2rad(angle_deg)
    cos, sin = np.cos(th), np.sin(th)

    # inverse-map output pixels to input pixels (nearest neighbor)
    ys, xs = np.mgrid[0:h, 0:w]
    xi = cos * (xs - cx) + sin * (ys - cy) + cx
    yi = -sin * (xs - cx) + cos * (ys - cy) + cy
    xi = np.clip(np.round(xi).astype(int), 0, w - 1)
    yi = np.clip(np.round(yi).astype(int), 0, h - 1)
    out = frame[yi, xi]

    labels = labels.copy()
    valid = labels[:, 20] >= 0
    pts = labels[:, :16].reshape(-1, 8, 2)
    px = pts[..., 0] - cx
    py = pts[..., 1] - cy
    # forward rotation of label points
    pts[..., 0] = cos * px - sin * py + cx
    pts[..., 1] = sin * px + cos * py + cy
    labels[:, :16] = pts.reshape(-1, 16)
    xsx = labels[:, 0:16:2]
    ysy = labels[:, 1:16:2]
    labels[valid, 16] = xsx[valid].min(1)
    labels[valid, 17] = ysy[valid].min(1)
    labels[valid, 18] = xsx[valid].max(1)
    labels[valid, 19] = ysy[valid].max(1)
    return out, labels


def tile_shuffle(frame: np.ndarray, labels: np.ndarray, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """2x2 tile permutation with label remapping; objects whose 2D box
    crosses a tile boundary are dropped (reference
    corrected_3D_dataset.py:427-492)."""
    h, w = frame.shape[:2]
    th, tw = h // 2, w // 2
    perm = rng.permutation(4)
    out = frame.copy()
    # tile k occupies (row k//2, col k%2)
    origins = [(0, 0), (0, tw), (th, 0), (th, tw)]
    for dst, src in enumerate(perm):
        sy, sx = origins[src]
        dy, dx = origins[dst]
        out[dy : dy + th, dx : dx + tw] = frame[sy : sy + th, sx : sx + tw]

    new_labels = []
    for lab in labels:
        if lab[20] < 0:
            continue
        x1, y1, x2, y2 = lab[16:20]
        # which tile does the box live in entirely?
        col = 0 if x2 < tw else (1 if x1 >= tw else -1)
        row = 0 if y2 < th else (1 if y1 >= th else -1)
        if col < 0 or row < 0:
            continue  # crosses boundary: drop
        src = row * 2 + col
        dst = int(np.where(perm == src)[0][0])
        sy, sx = origins[src]
        dy, dx = origins[dst]
        l2 = lab.copy()
        l2[0:16:2] += dx - sx
        l2[1:16:2] += dy - sy
        l2[16:20:2] += dx - sx
        l2[17:20:2] += dy - sy
        new_labels.append(l2)
    return out, np.asarray(new_labels, np.float32).reshape(-1, 21)


class SyntheticDetectionDataset:
    """Infinite sampler of (frame [H,W,3], labels [MAX_OBJS,21]) pairs."""

    def __init__(
        self,
        image_shape: Tuple[int, int] = (256, 384),
        n_objects: int = 6,
        seed: int = 0,
        augment: bool = True,
        crop_mode: bool = False,
        crop_size: int = 112,
        zoom: float = 1.0,
        output_dtype: str = "float32",
        ignore_polygon=None,
        p_scale_aspect: float = 1.0,
        p_rotate: float = 0.5,
        p_tile: float = 0.5,
    ):
        self.image_shape = image_shape
        # per-camera ignore region (reference ignored_regions/*.csv,
        # corrected_3D_dataset.py:53-63): pixels inside are blacked out and
        # labels centered inside are dropped
        self.ignore_polygon = ignore_polygon
        self._ignore_mask = None
        if ignore_polygon is not None:
            from playground3d_tpu_torch.data.regions import polygon_mask

            self._ignore_mask = polygon_mask(
                np.asarray(ignore_polygon), image_shape[0], image_shape[1]
            )
        # "uint8": emit raw uint8 frames (normalized on the device by
        # models.retinanet.normalize_on_device): 4x fewer bytes to the
        # device than normalized float32
        self.output_dtype = output_dtype
        self.augment = augment
        # geometric aug probabilities (reference corrected_3D_dataset.py:
        # scale/aspect always :331, rotate always :438, tile p=0.75 :427 —
        # rotate/tile default lower here: the full-frame remap is host-heavy
        # and the 2x2 tile variant drops boundary objects)
        self.p_scale_aspect = p_scale_aspect
        self.p_rotate = p_rotate
        self.p_tile = p_tile
        self.crop_mode = crop_mode
        self.crop_size = crop_size
        self.rng = np.random.default_rng(seed)
        self.n_objects = n_objects
        self.zoom = zoom  # >1 narrows the FoV: use ~3 for low-res smoke
        # tests so object hulls reach the smallest (32 px) anchor scale
        self._P = self._make_camera()

    def _make_camera(self):
        # reuse the synthetic pole camera; scale intrinsics to image size
        from playground3d_tpu_torch.geometry.homography import build_projection, fit_homography

        # Like the real I-24 pole cameras: long lens viewing a band 200-400ft
        # down-road at shallow pitch, so vehicle hulls have ~unit aspect
        # (a close/steep camera yields 10:1-tall hulls outside the anchor
        # ratio set {0.5,1,2} — the reference anchors assume this geometry).
        h, w = self.image_shape
        f = 2000.0 * w / 1920.0 * self.zoom
        cam_pos = np.array([250.0, 60.0, -30.0])

        def make_project(cx, cy):
            def project(p3):
                d = p3 - cam_pos
                yaw, pitch = np.deg2rad(4.0), np.deg2rad(6.0)
                Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
                Rx = np.array([[1, 0, 0], [0, np.cos(pitch), -np.sin(pitch)], [0, np.sin(pitch), np.cos(pitch)]])
                cam = np.stack([d[:, 1], -d[:, 2], d[:, 0]], 1) @ Ry.T @ Rx.T
                return np.stack([f * cam[:, 0] / cam[:, 2] + cx, f * cam[:, 1] / cam[:, 2] + cy], 1)

            return project

        # auto-frame: put the center of the spawn band at the image center
        probe = make_project(0.0, 0.0)(np.array([[550.0, 60.0, -3.0]]))[0]
        project = make_project(w / 2.0 - probe[0], h / 2.0 - probe[1])
        self._project = project
        rng = np.random.default_rng(42)
        sp = np.stack([rng.uniform(450, 680, 24), rng.uniform(0, 120, 24)], 1)
        im = project(np.concatenate([sp, np.zeros((24, 1))], 1))
        Hi = fit_homography(sp, im)
        H = fit_homography(im, sp)
        vp_z = project(np.array([[550.0, 60.0, -1e7]]))[0]
        P = build_projection(Hi, vp_z)

        # calibrate P's z-column scale against true-projected 3D boxes
        # (the reference's scale_Z flow, homography.py:607-666)
        from playground3d_tpu_torch.evaluation import geometry_np as G
        from playground3d_tpu_torch.geometry.homography import scale_P_z

        states = np.stack(
            [
                rng.uniform(460, 660, 10),
                rng.uniform(10, 110, 10),
                rng.uniform(14, 20, 10),
                rng.uniform(5.5, 7, 10),
                rng.uniform(4, 6, 10),
                np.ones(10),
            ],
            axis=1,
        )
        space = G.state_to_space(states)
        boxes_im = project(space.reshape(-1, 3)).reshape(-1, 8, 2).astype(np.float32)
        return scale_P_z(P, boxes_im, states[:, 4].astype(np.float32), H)

    def camera_registry(self):
        """CameraRegistry fit on this dataset's projector — so a tracker can
        consume detections from a detector trained on this dataset."""
        from playground3d_tpu_torch.geometry.homography import CameraRegistry

        rng = np.random.default_rng(123)
        sp = np.stack([rng.uniform(450, 680, 24), rng.uniform(0, 120, 24)], 1)
        corr = self._project(np.concatenate([sp, np.zeros((24, 1))], 1))
        vp_z = self._project(np.array([[550.0, 60.0, -1e7]]))[0]
        h, w = self.image_shape
        reg = CameraRegistry()
        reg.add_camera("p1c1", corr, sp, np.array([[1e6, h / 2], [w / 2, 1e6], vp_z]))
        reg.set_P("p1c1", self._P)
        return reg

    def sample(self) -> Tuple[np.ndarray, np.ndarray]:
        # spawn objects 100-330 ft down-road of the camera (at x=350): closer
        # objects project at extreme perspective (hyper-tall hulls no anchor
        # ratio covers), matching the real cameras' viewing band
        scene = SyntheticScene(
            n_objects=self.n_objects,
            seed=int(self.rng.integers(0, 2**31)),
            x_spawn=(450.0, 660.0),
            x_visible=(445.0, 680.0),
        )
        t = float(self.rng.uniform(0, 3.0))
        h, w = self.image_shape
        frame, labels = render_frame(
            scene, t, self._P, height=h, width=w, rng=self.rng,
            normalized=self.output_dtype != "uint8",
        )
        if self._ignore_mask is not None:
            frame = frame.copy()
            frame[self._ignore_mask] = 0.0
            if len(labels) > 0:
                cx = (labels[:, 16] + labels[:, 18]) / 2
                cy = (labels[:, 17] + labels[:, 19]) / 2
                from playground3d_tpu_torch.data.regions import points_in_polygon

                inside = points_in_polygon(
                    np.stack([cx, cy], 1), np.asarray(self.ignore_polygon)
                )
                labels = labels[~inside]
        if self.crop_mode:
            if len(labels) > 0:
                frame, labels = self._crop_around_object(frame, labels)
            else:
                # negative crop: random window, no labels (keeps batch shapes)
                h, w = frame.shape[:2]
                cs = self.crop_size
                y0 = int(self.rng.integers(0, max(h - cs, 1)))
                x0 = int(self.rng.integers(0, max(w - cs, 1)))
                frame = frame[y0 : y0 + cs, x0 : x0 + cs]
                labels = np.zeros((0, 21), np.float32)
        if self.augment:
            frame = photometric_jitter(frame, self.rng)
            if not self.crop_mode:
                # geometric augs (full-frame mode only; crop mode centers an
                # object and does its own windowing — reference keeps these
                # augs out of CROP mode too, corrected_3D_dataset.py:501)
                if self.rng.uniform() < self.p_scale_aspect:
                    frame, labels = scale_aspect(frame, labels, self.rng)
            if self.rng.uniform() < 0.5:
                frame, labels = hflip(frame, labels)
            if not self.crop_mode:
                if self.rng.uniform() < self.p_rotate:
                    angle = float(self.rng.uniform(-20.0, 20.0))
                    frame, labels = rotate(frame, labels, angle)
                    # drop labels fully outside after rotation (ref :395-397)
                    valid = labels[:, 20] >= 0
                    keep = ~valid | (
                        (labels[:, 16] < frame.shape[1]) & (labels[:, 18] >= 0)
                        & (labels[:, 17] < frame.shape[0]) & (labels[:, 19] >= 0)
                    )
                    labels = labels[keep]
                if self.rng.uniform() < self.p_tile:
                    frame, labels = tile_shuffle(frame, labels, self.rng)
        if self.output_dtype == "uint8":
            frame = (np.clip(frame, 0.0, 1.0) * 255.0).astype(np.uint8)
            return frame, pad_labels(labels)
        return frame.astype(np.float32), pad_labels(labels)

    def _crop_around_object(self, frame, labels):
        """Object-centered square crop resized to crop_size (CROP mode,
        corrected_3D_dataset.py:501-594)."""
        i = int(self.rng.integers(0, len(labels)))
        lab = labels[i]
        cx = (lab[16] + lab[18]) / 2
        cy = (lab[17] + lab[19]) / 2
        size = max(lab[18] - lab[16], lab[19] - lab[17]) * self.rng.uniform(1.1, 1.6)
        size = max(size, 8.0)
        h, w = frame.shape[:2]
        x0 = int(np.clip(cx - size / 2, 0, w - 2))
        y0 = int(np.clip(cy - size / 2, 0, h - 2))
        x1 = int(np.clip(cx + size / 2, x0 + 1, w))
        y1 = int(np.clip(cy + size / 2, y0 + 1, h))
        crop = frame[y0:y1, x0:x1]
        # nearest resize to crop_size
        cs = self.crop_size
        yi = (np.arange(cs) * (crop.shape[0] / cs)).astype(int)
        xi = (np.arange(cs) * (crop.shape[1] / cs)).astype(int)
        out = crop[yi][:, xi]
        # remap labels into crop coordinates; keep objects whose center is inside
        new = []
        sx = cs / (x1 - x0)
        sy = cs / (y1 - y0)
        for lab in labels:
            l2 = lab.copy()
            l2[0:16:2] = (l2[0:16:2] - x0) * sx
            l2[1:16:2] = (l2[1:16:2] - y0) * sy
            l2[16:20:2] = (l2[16:20:2] - x0) * sx
            l2[17:20:2] = (l2[17:20:2] - y0) * sy
            ccx = (l2[16] + l2[18]) / 2
            ccy = (l2[17] + l2[19]) / 2
            if 0 <= ccx < cs and 0 <= ccy < cs:
                new.append(l2)
        return out, np.asarray(new, np.float32).reshape(-1, 21)

    def batches(self, batch_size: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            frames, labels = zip(*(self.sample() for _ in range(batch_size)))
            yield np.stack(frames), np.stack(labels)

    def batch_factory(self, batch_size: int, seed: int = 0):
        """Thread-safe zero-arg batch producer for a multi-worker Prefetcher:
        each worker thread gets its own lightweight clone (shared fitted
        camera, independent rng stream)."""
        import threading as _threading

        lock = _threading.Lock()
        counter = [0]
        local = _threading.local()

        def make():
            ds = getattr(local, "ds", None)
            if ds is None:
                with lock:
                    k = counter[0]
                    counter[0] += 1
                ds = object.__new__(SyntheticDetectionDataset)
                ds.__dict__.update(self.__dict__)
                ds.rng = np.random.default_rng(seed * 100003 + k)
                local.ds = ds
            frames, labels = zip(*(ds.sample() for _ in range(batch_size)))
            return np.stack(frames), np.stack(labels)

        return make


class CachedDetectionDataset:
    """Frames + labels from .npz shards: each shard holds ``frames``
    [n,H,W,3] uint8 and ``labels`` [n,MAX_OBJS,21]."""

    def __init__(self, shard_paths, augment: bool = True, seed: int = 0):
        self.paths = list(shard_paths)
        self.augment = augment
        self.rng = np.random.default_rng(seed)

    def batches(self, batch_size: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            path = self.paths[int(self.rng.integers(0, len(self.paths)))]
            z = np.load(path)
            frames, labels = z["frames"], z["labels"]
            idx = self.rng.permutation(len(frames))
            for k in range(0, len(idx) - batch_size + 1, batch_size):
                sel = idx[k : k + batch_size]
                f = frames[sel].astype(np.float32) / 255.0
                f = (f - IMAGENET_MEAN) / IMAGENET_STD
                l = labels[sel].astype(np.float32)
                if self.augment:
                    for b in range(len(f)):
                        f[b] = photometric_jitter(f[b], self.rng)
                yield f, l


class Prefetcher:
    """Background-thread batch prefetcher with bounded depth (replaces the
    reference's queue-of-5 worker processes, util_track/mp_loader.py:218).

    ``workers > 1`` runs several producer threads over a thread-safe
    ``factory`` (a zero-arg callable returning one batch), for when batch
    production is CPU-bound and numpy releases the GIL. With an
    ``iterator`` the single producer keeps the order.

    Each array of a batch becomes a tensor on ``device`` (the card unless
    the caller asks for the CPU): on a CUDA device through pinned host
    memory and a ``non_blocking`` copy on a side stream of the producer
    thread's own, so the copy overlaps the step that runs on the consumer's
    stream; ``__next__`` makes the consumer's stream wait for the batch's
    copy and hands the tensors over to that stream. ``seconds`` sums the
    producers' host time by stage (``produce``: the dataset; ``stage``:
    pinning and the copy's enqueue) over ``batches`` batches.
    """

    def __init__(
        self,
        iterator: Optional[Iterator] = None,
        depth: int = 3,
        device: DeviceLike = None,
        factory=None,
        workers: int = 1,
    ):
        if (iterator is None) == (factory is None):
            raise ValueError("Prefetcher: pass exactly one of iterator and factory")
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.device = resolve_device(device)
        self.seconds = {"produce": 0.0, "stage": 0.0}
        self.batches = 0
        self._lock = threading.Lock()
        self._done = object()
        self._stop = False
        if factory is not None:
            self.threads = [
                threading.Thread(target=self._work_factory, args=(factory,), daemon=True)
                for _ in range(max(workers, 1))
            ]
        else:
            self.threads = [threading.Thread(target=self._work_iter, args=(iterator,), daemon=True)]
        for t in self.threads:
            t.start()

    def _stage(self, item, t0: float, stream=None):
        """-> (tensors, the event their copy is done at or None)."""
        t1 = time.perf_counter()
        tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in item]
        ready = None
        if stream is None:
            tensors = tuple(t.to(self.device) for t in tensors)
        else:
            with torch.cuda.stream(stream):
                tensors = tuple(t.pin_memory().to(self.device, non_blocking=True) for t in tensors)
                ready = torch.cuda.Event()
                ready.record(stream)
        t2 = time.perf_counter()
        with self._lock:
            self.seconds["produce"] += t1 - t0
            self.seconds["stage"] += t2 - t1
            self.batches += 1
        return tensors, ready

    def _side_stream(self):
        return torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def _put(self, item) -> bool:
        """Bounded put that re-checks the stop flag, so producer threads see
        close() instead of blocking forever on a full queue."""
        while not self._stop:
            try:
                self.q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _work_iter(self, it):
        try:
            stream = self._side_stream()
            while not self._stop:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                if not self._put(self._stage(item, t0, stream)):
                    return
        finally:
            self._put(self._done)

    def _work_factory(self, factory):
        stream = self._side_stream()
        while not self._stop:
            t0 = time.perf_counter()
            if not self._put(self._stage(factory(), t0, stream)):
                return

    def close(self, timeout: float = 10.0):
        """Stop the producers, drop what is queued, and join the threads."""
        self._stop = True
        for t in self.threads:
            while t.is_alive():
                try:
                    while True:
                        self.q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.1)
                timeout -= 0.1
                if timeout <= 0:
                    raise RuntimeError("Prefetcher.close: a producer thread did not stop")

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._done:
            raise StopIteration
        tensors, ready = item
        if ready is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(ready)
            for t in tensors:
                t.record_stream(current)
        return tensors
