"""A new configuration, traffic mix and per-layer metric are files and
entries only: the harness finds them by name in a copy of the checkout
without an edit to any file that is there."""

import json
import shutil
from types import SimpleNamespace

from cellbench.manifest import ROOT, Manifest


def test_new_files_are_found(tmp_path):
    shutil.copytree(ROOT / "cellbench", tmp_path / "cellbench", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "cellbench").rglob("*") if p.is_file()}

    cfg = json.loads((tmp_path / "cellbench/configs/r50_s2d_int8.json").read_text())
    cfg["tracker"]["det_step"] = 12
    (tmp_path / "cellbench/configs/r50_s2d_int8_d12.json").write_text(json.dumps(cfg))
    mix = json.loads((tmp_path / "cellbench/traffic/pole6_yuv_backlog.json").read_text())
    mix["cameras"] = mix["cameras"][:4]
    (tmp_path / "cellbench/traffic/pole4_yuv_backlog.json").write_text(json.dumps(mix))
    (tmp_path / "cellbench/metrics/frames_per_clip.py").write_text(
        'UNIT = "frames"\nLAYER = "clip loop"\nMOVES = "camera_frames_per_s"\nSOURCE = "host_clock"\n'
        "TRACED = True\n\n\ndef read(ctx):\n    return ctx.frames / ctx.clips\n")
    bench["configs"].append(dict(bench["configs"][0], name="r50_s2d_int8_d12",
                                 file="cellbench/configs/r50_s2d_int8_d12.json"))
    bench["workloads"].append({"name": "r50_s2d_int8_d12.pole4_yuv_backlog", "config": "r50_s2d_int8_d12",
                               "traffic": "pole4_yuv_backlog", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "frames_per_clip", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "clip loop", "moves": "camera_frames_per_s",
                               "workloads": ["r50_s2d_int8_d12.pole4_yuv_backlog"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    man = Manifest(tmp_path)
    wl = man.workload("r50_s2d_int8_d12.pole4_yuv_backlog")
    assert man.config(wl["config"])["tracker"]["det_step"] == 12
    assert len(man.traffic(wl["traffic"])["cameras"]) == 4
    assert "frames_per_clip" in [m["name"] for m in man.per_layer(wl["name"])]
    assert "frames_per_clip" not in [m["name"] for m in man.per_layer("r50_s2d_int8.pole6_yuv_backlog")]
    assert man.reader("frames_per_clip").read(SimpleNamespace(frames=48, clips=2)) == 24
    after = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "cellbench").rglob("*")
             if p.is_file() and p.relative_to(tmp_path) in before}
    assert after == before
