"""Recording-session configuration utilities (standard-library copy of
``playground3d_tpu/data/session.py``).

The I-24 video-ingest sessions write a ``_SESSION_CONFIG.config`` (block
structured ``__CAMERA__`` / ``__IMAGE-SNAPSHOT__`` / ``__VIDEO-SNAPSHOT__`` /
``__PERSISTENT-RECORDING__`` sections of ``key == value`` pairs) and a
``_SESSION_INFO.txt`` next to the recordings. These helpers parse them and
locate the per-camera recording segments — functionality-parity with
reference timestamp_utilities.py:118-333 (parse_config_file,
get_session_start_time_local, get_session_recording_segment_time,
get_session_number, get_recording_params, find_files,
get_manager_log_files).
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "parse_config_file",
    "get_session_start_time_local",
    "get_session_recording_segment_time",
    "get_session_number",
    "get_recording_params",
    "find_files",
    "get_manager_log_files",
]

SESSION_INFO_FILENAME = "_SESSION_INFO.txt"
SESSION_CONFIG_FILENAME = "_SESSION_CONFIG.config"
DEFAULT_RECORDING_FILENAME = "./recording/record_{cam_name}_%05d.mp4"

_BLOCKS = (
    "__CAMERA__",
    "__IMAGE-SNAPSHOT__",
    "__VIDEO-SNAPSHOT__",
    "__PERSISTENT-RECORDING__",
)
_SINGLETON_BLOCKS = _BLOCKS[1:]


def parse_config_file(config_file: str):
    """Parse a session config into (camera_configs [list of dict],
    image_snap_config, video_snap_config, recording_config [dict each]).

    Blocks open with a ``__NAME__`` header line; entries are ``key == value``;
    blank lines and ``#`` comments are ignored. Only the camera section may
    repeat (reference timestamp_utilities.py:118-176)."""
    sections: Dict[str, List[dict]] = {b: [] for b in _BLOCKS}
    current: Optional[dict] = None
    dest: Optional[List[dict]] = None
    with open(config_file) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            if len(s) > 4 and s.startswith("__") and s.endswith("__"):
                if s not in sections:
                    raise AttributeError(f"unknown configuration block {s}")
                if dest is not None and current:
                    dest.append(current)
                current = {}
                dest = sections[s]
            elif "==" in s:
                if current is None:
                    raise AttributeError(f"key-value before any block header: {s}")
                k, v = s.split("==", 1)
                current[k.strip()] = v.strip()
            else:
                raise AttributeError(
                    f"line is neither a block header nor key == value: {s}"
                )
    if dest is not None and current:
        dest.append(current)

    out = [sections["__CAMERA__"]]
    for b in _SINGLETON_BLOCKS:
        blocks = sections[b]
        if len(blocks) > 1:
            raise AttributeError(f"more than one configuration block for {b}")
        out.append(blocks[0] if blocks else [])
    return tuple(out)


def _info_line(session_info_filename: str, prefix: str) -> str:
    with open(session_info_filename) as f:
        for line in f:
            if line.startswith(prefix):
                return line[len(prefix):].strip()
    raise ValueError(f"no line starting with {prefix!r} in {session_info_filename}")


def get_session_start_time_local(session_info_filename: str) -> datetime.datetime:
    """Local session start time from _SESSION_INFO.txt
    (reference :179-194)."""
    ts = _info_line(session_info_filename, "Session initialization time (local): ")
    return datetime.datetime.strptime(ts, "%Y-%m-%d %H:%M:%S.%f")


def get_session_recording_segment_time(session_info_filename: str) -> float:
    """Recording segment duration in minutes (reference :197-211)."""
    return float(_info_line(session_info_filename, "Recording segment duration: "))


def get_session_number(session_info_filename: str) -> int:
    """Session number (reference :214-226)."""
    return int(_info_line(session_info_filename, "SESSION #"))


def get_recording_params(
    session_root_directory: str,
    session_number: Optional[int] = None,
    camera_configs: Optional[List[dict]] = None,
    recording_config: Optional[dict] = None,
) -> Tuple[List[str], List[str], List[str]]:
    """Per-camera (recording_dirs, file_name_formats, camera_names) from a
    session directory (reference :229-275). Placeholders ``{cam_name}`` and
    ``{session_num}`` are substituted; ``./``-relative directories resolve
    against the session root."""
    if camera_configs is None or recording_config is None:
        camera_configs, _, _, recording_config = parse_config_file(
            os.path.join(session_root_directory, SESSION_CONFIG_FILENAME)
        )
    if session_number is None:
        session_number = get_session_number(
            os.path.join(session_root_directory, SESSION_INFO_FILENAME)
        )
    cam_names = [c["name"] for c in camera_configs]
    file_location = (
        recording_config.get("recording_filename", DEFAULT_RECORDING_FILENAME)
        if isinstance(recording_config, dict)
        else DEFAULT_RECORDING_FILENAME
    )
    file_dir, file_name = os.path.split(file_location)
    if file_dir.startswith("./"):
        file_dir = os.path.join(session_root_directory, file_dir[2:])
    rec_dirs = [
        file_dir.format(cam_name=c, session_num=session_number) for c in cam_names
    ]
    file_names = [
        file_name.format(cam_name=c, session_num=session_number) for c in cam_names
    ]
    return rec_dirs, file_names, cam_names


def find_files(
    recording_directories: Sequence[str],
    file_name_formats: Sequence[str],
    camera_names: Sequence[str],
    drop_last_file: bool = False,
    first_file_index: int = 0,
    filter_filenames: Optional[Sequence[str]] = None,
) -> List[Tuple[str, str, int, str]]:
    """Locate recording segments matching each camera's filename format
    (``%05d``-style segment counters become capture groups). Returns
    (directory, filename, segment_number, camera_name) tuples sorted by
    segment per camera (reference :278-317)."""
    regexes = [re.sub(r"%(0[0-9])*d", "([0-9]+)", fnf) for fnf in file_name_formats]
    matches: List[Tuple[str, str, int, str]] = []
    for cam, rdir, rex in zip(camera_names, recording_directories, regexes):
        cam_files = []
        for fl in sorted(os.listdir(rdir)):
            m = re.search(rex, fl)
            if m is None:
                continue
            seg = int(m.group(1))
            if seg >= first_file_index:
                cam_files.append((rdir, fl, seg, cam))
        cam_files.sort(key=lambda x: x[2])
        matches += cam_files[:-1] if drop_last_file else cam_files
    if filter_filenames is not None:
        matches = [
            m
            for m in matches
            if any(f in os.path.join(m[0], m[1]) for f in filter_filenames)
        ]
    return matches


def get_manager_log_files(
    session_directory: str, log_directory: Optional[str] = None
) -> List[str]:
    """Video-ingest manager log files (``manager-<ts>.log``,
    reference :320-333)."""
    d = log_directory or os.path.join(session_directory, "logs")
    return sorted(
        fn for fn in os.listdir(d) if re.search(r"manager-(.*)\.log", fn)
    )
