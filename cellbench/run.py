"""One run of one cell of the benchmark:

    python3 -m cellbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It makes the frames and weights from the
seed, builds the tracker through the program's entry points, warms up
(which captures the clip's CUDA graphs), then measures for ``--seconds``:
a closed-loop backlog of the cell's cameras through
``MultiCameraTracker.track_clips`` until every clip it enqueued has been
read back. Then the program is freed and the plain reference checks
sampled clips of what it produced. The last line of standard output is the
result (JSON); the last lines of standard error give each number compared
beside its limit.

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a window traced by PyTorch's profiler (CUDA
activity), with ``busy_s``, ``window_s`` and a breakdown.
"""

from __future__ import annotations

import time

T_START = time.perf_counter_ns()  # the process's start, as near as this module sees it

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "playground3d_tpu")  # top-level module names this process may not hold


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules' top-level names (the part before the first dot,
    compared whole) that are JAX's or the JAX package's."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def calibration(cfg: dict, traffic: dict, rings, seed: int, device) -> dict:
    """The int8 calibration batches both sides quantize on, by net: the
    first camera's first frame as the detector sees it, and four random
    crops in the crop net's layout; none for a float configuration."""
    import torch

    from cellbench import archs, cell

    if cfg["precision"] != "int8":
        return {}
    if archs.layout(cfg["detector"]) != "s2d" or archs.layout(cfg["crop_net"]) != "s2d":
        raise ValueError("an int8 configuration's nets take s2d-packed frames")
    from cellbench.reference.models.resnet import space_to_depth
    from cellbench.reference.ops.yuv420 import yuv420_flat_to_s2d

    frame = torch.as_tensor(cell.clip_frames(traffic, rings, 0, 1)).to(device)  # [1, C, ...]
    if traffic["format"] == "yuv420":
        packed = yuv420_flat_to_s2d(frame, (traffic["height"], traffic["width"]))[0, 0]
    else:
        packed = space_to_depth(frame[0, :1], 4)[0]
    cs = cfg["tracker"]["cs"]
    gen = torch.Generator(device=device)
    gen.manual_seed(cell.sub_seed(seed, 6))
    crops = torch.randint(0, 256, archs.images_shape(cfg["crop_net"], 4, cs, cs), generator=gen, device=device,
                          dtype=torch.uint8)
    return {"detector": packed[None], "crop_net": crops}


def frame_ops(cfg: dict, traffic: dict, crops: int):
    """(operations of one detect frame over every camera, of one crop frame
    of ``crops`` crops), each by the precision it runs in, from the nets'
    architecture modules at the cell's input shapes."""
    from cellbench import archs

    t, det, crop = cfg["tracker"], cfg["detector"], cfg["crop_net"]
    det_shape = archs.images_shape(det, len(traffic["cameras"]), traffic["height"], traffic["width"])
    return (archs.of(det).ops(det, det_shape, cfg["precision"], t["det_min_level"]),
            archs.of(crop).ops(crop, archs.images_shape(crop, crops, t["cs"], t["cs"]), cfg["precision"]))


def branch_frames(n_frames: int, det_step: int, skip_step: int) -> Dict[str, int]:
    """Frames of each branch among a ``track_clips`` call's first
    ``n_frames`` (the branch follows the frame's index in the call)."""
    detect = len(range(0, n_frames, det_step))
    crop = sum(1 for i in range(n_frames) if i % det_step and i % skip_step == 0)
    return {"detect": detect, "crop": crop, "passthrough": n_frames - detect - crop}


def run_cell(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device, chips: int = 1,
             t_start: int = T_START, end_to_end: Optional[List[dict]] = None, per_layer: Optional[List[dict]] = None,
             readers: Optional[Dict[str, Callable]] = None, keep: Optional[dict] = None) -> dict:
    """One run; returns the result's fields. ``end_to_end`` / ``per_layer``
    are the manifest's metric entries the cell reports, ``readers`` the
    per-layer metrics' ``read`` functions by name. ``keep``, when given,
    receives what the check compared (for the control and the tests)."""
    import torch

    from cellbench import archs, cell, check, program
    from cellbench.trace import DeviceTrace, clock_offset_ns, label_gaps
    from cellbench.window import Backlog

    device = torch.device(device)
    on_card = device.type == "cuda"

    def mark(what: str) -> None:
        log(f"set-up: {what} at {(time.perf_counter_ns() - t_start) / 1e9:.2f} s")

    mark("imports")
    if on_card:
        program.build_kernels(cfg)
        mark("kernels built or found")
    n_cams, T = len(traffic["cameras"]), traffic["clip_len"]
    H, W = traffic["height"], traffic["width"]
    tc = cfg["tracker"]
    rings = cell.frame_rings(traffic, cell.sub_seed(seed, 1), device)
    jitter = cell.clock_jitter_s(traffic, cell.sub_seed(seed, 2))
    out_std = cfg["weights"]["output_conv_std"]
    weights = {
        "detector": archs.of(cfg["detector"]).raw_weights(cfg["detector"], cell.sub_seed(seed, 3), device, out_std),
        "crop_net": archs.of(cfg["crop_net"]).raw_weights(cfg["crop_net"], cell.sub_seed(seed, 4), device, out_std,
                                                          reg_bias_xy=cell.crop_target(cfg, traffic)),
    }
    calib = calibration(cfg, traffic, rings, seed, device)
    mark("frames, weights and calibration inputs made")
    trk, rec = program.build(cfg, traffic, weights, calib, device)
    mark("tracker built")
    offs = cell.ring_offsets(traffic)
    yuv_hw = (H, W) if traffic["format"] == "yuv420" else None
    warm_frames = traffic["warm_clips"] * T

    def source(first, **stop):
        return Backlog(rings, offs, traffic["t0"], traffic["fps"], jitter, T, first, **stop)

    trk.track_clips(source(0, n_frames=warm_frames).streams(), clip_len=T, yuv_hw=yuv_hw)
    if on_card:
        torch.cuda.synchronize(device)
    mark(f"warm-up of {warm_frames} frames")
    n_warm = len(rec.calls)
    timers0 = dict(trk.timers)
    rec.base = warm_frames
    tracer = DeviceTrace() if trace else None
    if tracer is not None:
        tracer.start()
    offset = clock_offset_ns()
    w0 = time.perf_counter_ns()
    backlog = source(warm_frames, deadline=w0 / 1e9 + seconds)
    stats = trk.track_clips(backlog.streams(), clip_len=T, yuv_hw=yuv_hw)
    w1 = time.perf_counter_ns()
    if tracer is not None:
        tracer.stop()
    window_s = (w1 - w0) / 1e9
    handed = backlog.end - warm_frames
    read_back = stats["frames"]
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    timers = {k: v - timers0.get(k, 0.0) for k, v in trk.timers.items()}
    spans = rec.spans[n_warm:]
    log(f"window: {read_back} frames of {n_cams} cameras read back in {window_s:.3f} s "
        f"({len(spans)} clips; handed over {handed}); host seconds {timers}")
    replays = program.replay_ms(rec) if trace and on_card else {}
    if tracer is not None:
        tracer.read(w0 + offset, w1 + offset)
        log(f"trace: {tracer.events} device events, busy {tracer.busy_s:.4f} s of {window_s:.4f}")

    # the program's part ends here: free it before the reference runs
    rows, final_state, final_tb, epoch = trk.rows, trk.state, trk.ts_bias, trk.epoch
    calls = rec.calls
    trk._clip = rec.clip = rec.runners = rec.shard_runners = None
    del trk
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = check.Reference(cfg, traffic, weights, calib, device, cfg["precision"])
    chosen = check.picks(cell.sub_seed(seed, 5), traffic["warm_clips"], len(calls), traffic["check_clips"])
    numbers, ref_outs = check.check(ref, rings, jitter, calls, rows, final_state, final_tb, chosen, T, log)
    log(f"check: {len(chosen)} clips {chosen} in {time.perf_counter() - t_ref:.2f} s")
    if keep is not None:
        keep.update(numbers=numbers, ref_outs=ref_outs, chosen=chosen, calls=calls, rings=rings, jitter=jitter,
                    weights=weights, calib=calib, ref=ref, rows=rows, epoch=epoch)
    limits = cfg["limits"]
    failed = (handed - read_back) * n_cams
    correct = failed == 0 and all(numbers[k] <= limits[k] for k in check.NUMBERS)

    metrics: Dict[str, dict] = {}
    if not trace:
        values = {"camera_frames_per_s": read_back * n_cams / window_s, "setup_s": (w0 - t_start) / 1e9}
        for m in end_to_end or []:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        crop_frames = [warm_frames + j for j in range(read_back) if j % tc["det_step"] and j % tc["skip_step"] == 0]
        t_crop = time.perf_counter()
        crop_bytes = ref.crop_bytes_from_rows(rows, epoch, calls, jitter, crop_frames)
        k = tc["crop_slots"] if 0 < tc["crop_slots"] < tc["max_tracks"] else tc["max_tracks"]
        crowded = sum(len(rows[g - 1][3]) > k for g in crop_frames)
        log(f"crop bytes of {len(crop_frames)} crop frames counted in {time.perf_counter() - t_crop:.2f} s "
            f"({crowded} with more live tracks than crop slots, scaled)")
        det_ops, crop_ops = frame_ops(cfg, traffic, k)
        ctx = SimpleNamespace(
            cfg=cfg, traffic=traffic, n_cams=n_cams, clip_len=T, clips=len(spans), frames=read_back,
            camera_frames=read_back * n_cams, window_s=window_s, timers=timers,
            branch_frames=branch_frames(read_back, tc["det_step"], tc["skip_step"]),
            clip_starts_ns=[s for s, _ in spans], trace=tracer, replay_ms=replays,
            det_ops=det_ops, crop_ops=crop_ops, qconv_frames=ref.qconv_frames, crop_bytes=crop_bytes,
        )
        for m in per_layer or []:
            value = readers[m["name"]](ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": handed * n_cams, "failed": failed, "metrics": metrics}
    if on_card:
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                            "memory_peak_bytes": int(peak)}
        if tracer is not None:
            result["device"].update(busy_s=tracer.busy_s, window_s=window_s)
            result["breakdown"] = {
                "device_ops": tracer.top_ops(),
                "idle_gaps": label_gaps(tracer.gaps, spans, backlog.handed, offset),
            }
    else:
        result["device"] = {"platform": "cpu"}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in check.NUMBERS}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from cellbench.manifest import Manifest

    man = Manifest()
    wl = man.workload(args.workload)
    cache = man.pkg / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        log(f"cellbench: the cell needs {wl['chips']} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    per_layer = man.per_layer(wl["name"]) if args.trace else []
    readers = {m["name"]: man.reader(m["name"]).read for m in per_layer}
    result = run_cell(man.config(wl["config"]), man.traffic(wl["traffic"]), args.seed, args.seconds,
                      bool(args.trace), "cuda:0", chips=wl["chips"], end_to_end=man.end_to_end(wl["name"]),
                      per_layer=per_layer, readers=readers)
    found = forbidden_modules()
    if found:
        log(f"cellbench: this process holds {found}, which the benchmark may not load")
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        log(f"{name} {c['value']} limit {c['limit']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
