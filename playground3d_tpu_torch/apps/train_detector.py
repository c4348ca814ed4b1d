"""Detector training CLI (port of ``playground3d_tpu/apps/train_detector.py``;
reference train_detector_3D_angle.py / train_crop_detector.py).

Trains the directional RetinaNet (full-frame mode) or the crop detector
(``--crop``: object-centered square crops, the reference's CROP=112
localizer) on the synthetic dataset or cached .npz shards, with the plateau
learning-rate schedule and per-epoch npz checkpoints in the JAX package's
format. Runs on the CUDA card unless ``--device cpu``. A background thread
renders and stages batches (``data/dataset.py::Prefetcher``); an epoch's
losses stay on the device and are read once at its end.

``--dp`` trains data-parallel over every visible card (JAX's ``make_mesh()``):
one process a card (``torch.multiprocessing.spawn``; NCCL, joined through a
rendezvous file in a temporary directory). Every rank renders the same
global batches as the one-process app and trains on its slice of each
(``Trainer(mesh=)``); rank 0 prints, writes the checkpoints and returns the
summary. With one device ``--dp`` trains as without it.

Usage:
    python -m playground3d_tpu_torch.apps.train_detector --steps 500 --batch 8 \\
        --height 512 --width 768 --out detector.npz
    python -m playground3d_tpu_torch.apps.train_detector --crop --crop-size 112 ...
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--steps-per-epoch", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=768)
    ap.add_argument("--zoom", type=float, default=1.5)
    ap.add_argument("--crop", action="store_true", help="train the crop detector")
    ap.add_argument("--crop-size", type=int, default=112)
    ap.add_argument("--shards", nargs="*", default=None, help="cached .npz shards")
    ap.add_argument("--out", default="detector.npz")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--dp", action="store_true",
                    help="data-parallel over all devices, one process each (one device trains as without it)")
    ap.add_argument("--stem", default="conv7", choices=["conv7", "s2d"])
    ap.add_argument("--feature-size", type=int, default=256)
    ap.add_argument("--tower-depth", type=int, default=4)
    ap.add_argument("--shared-tower", action="store_true")
    ap.add_argument(
        "--f32-wire", action="store_true",
        help="ship normalized f32 frames instead of uint8 (4x the transfer)",
    )
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the training loop; -> a summary: steps, wall seconds, per-epoch
    mean losses and learning rates, the Prefetcher's host seconds by stage
    and batches, the checkpoint path and the number of ranks."""
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)

    from playground3d_tpu_torch import resolve_device
    from playground3d_tpu_torch.train.trainer import data_parallel_devices

    device = resolve_device(args.device)
    n = data_parallel_devices(device) if args.dp else 1
    if n == 1:  # JAX's mesh of one device trains as no mesh does
        return train(args, device)
    return spawn_ranks(argv, device, n)


def spawn_ranks(argv, device, n: int) -> dict:
    """``--dp`` over ``n`` devices: one process a device, on a mesh of every
    visible card (or of the CPU ``n`` times); -> rank 0's summary, which it
    leaves in a file beside the rendezvous (a queue's pipe would block rank 0
    on a summary larger than its buffer while the parent waits for the
    ranks to end)."""
    import os
    import pickle
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    devices = [f"cuda:{i}" for i in range(n)] if device.type == "cuda" else [str(device)] * n
    rendezvous = tempfile.mkdtemp(prefix="train_detector_dp_")
    try:
        mp.spawn(rank_main, args=(argv, devices, f"file://{rendezvous}/rendezvous", rendezvous), nprocs=n)
        with open(os.path.join(rendezvous, "summary.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(rendezvous, ignore_errors=True)


def rank_main(rank: int, argv, devices, init_method: str, out_dir: str) -> None:
    """One rank of ``--dp``: join the group, train, and (rank 0) write the
    summary to ``out_dir``."""
    import os
    import pickle

    import torch
    import torch.distributed as dist

    from playground3d_tpu_torch.parallel.mesh import join_data_parallel, make_mesh

    mesh = make_mesh(devices=devices)
    if mesh.lead.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size))
    device = join_data_parallel(mesh, rank, init_method)
    try:
        summary = train(parse_args(argv), device, mesh)
        if rank == 0:
            with open(os.path.join(out_dir, "summary.pkl"), "wb") as f:
                pickle.dump(summary, f)
    finally:
        dist.destroy_process_group()


def train(args: argparse.Namespace, device, mesh=None) -> dict:
    """The training loop on ``device`` (one rank of ``mesh``'s group, with
    a mesh: rank 0 prints and writes)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from playground3d_tpu_torch.data.dataset import (
        CachedDetectionDataset,
        Prefetcher,
        SyntheticDetectionDataset,
    )
    from playground3d_tpu_torch.train.trainer import TrainConfig, Trainer

    lead = mesh is None or dist.get_rank() == 0
    shape = (args.crop_size, args.crop_size) if args.crop else (args.height, args.width)
    cfg = TrainConfig(
        depth=args.depth, image_shape=shape, lr=args.lr, stem=args.stem,
        feature_size=args.feature_size, tower_depth=args.tower_depth,
        shared_tower=args.shared_tower,
    )
    trainer = Trainer(cfg, generator=torch.Generator().manual_seed(0), mesh=mesh, device=device)
    if args.resume:
        trainer.load(args.resume)

    if args.shards:
        ds = CachedDetectionDataset(args.shards)
    else:
        ds = SyntheticDetectionDataset(
            image_shape=(args.height, args.width),
            crop_mode=args.crop,
            crop_size=args.crop_size,
            zoom=args.zoom,
            # uint8 to the device, normalized there by forward_raw: 4x fewer
            # bytes to copy than normalized float32
            output_dtype="float32" if args.f32_wire else "uint8",
        )
    batches = Prefetcher(ds.batches(args.batch), depth=3, device=device)

    start = time.time()
    epoch_losses, epochs, steps = [], [], 0
    try:
        for step, (frames, labels) in zip(range(args.steps), batches):
            m = trainer.train_step(frames, labels)
            steps = step + 1
            # the loss stays a device scalar: a read every step would make the
            # host wait for the card before it queues the next step
            epoch_losses.append(m["loss"])
            if step % 10 == 0 and lead:
                loss = float(m["loss"])
                rate = (step + 1) / (time.time() - start)
                print(
                    f"\rstep {step}: loss={loss:.4f} cls={float(m['cls']):.4f} "
                    f"reg={float(m['reg']):.4f} vp={float(m['vp']):.4f} "
                    f"({rate:.2f} it/s)",
                    end="", flush=True,
                )
            if (step + 1) % args.steps_per_epoch == 0:
                # one read of the epoch's losses
                mean = float(np.mean(torch.stack(epoch_losses).cpu().numpy()))
                trainer.end_epoch(mean)
                epochs.append({"step": step + 1, "loss": mean, "lr": trainer.lr})
                epoch_losses = []
                if lead:
                    trainer.save(args.out)
                    print(f"\nepoch checkpoint -> {args.out} (lr={trainer.lr:.2e})")
    finally:
        batches.close()

    if lead:
        trainer.save(args.out)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.time() - start
    if lead:
        print(f"\ndone; final checkpoint -> {args.out}")
    return {"steps": steps, "seconds": seconds, "epochs": epochs, "lr": trainer.lr, "out": args.out,
            "prefetch": dict(batches.seconds, batches=batches.batches), "ranks": 1 if mesh is None else mesh.size}


if __name__ == "__main__":
    main()
