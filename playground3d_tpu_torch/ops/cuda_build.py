"""Build and bind the hand-written CUDA kernels: one loader for every source
under ``csrc/``.

A :class:`KernelLibrary` names one ``.cu`` file. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
into ``playground3d_tpu_torch/_build/`` (named by a digest of source, the
``csrc/*.cuh`` headers and flags, so an edited source or header is
rebuilt), and bound with ``ctypes``. Nothing here imports a GPU package or
runs ``nvcc`` when a module is imported, and nothing falls back when the
build fails: it raises.

Every source exports ``const char* kernel_error_string(int)``; every launcher
returns the ``cudaError_t`` of its launch, which :meth:`KernelLibrary.check`
turns into an exception.

Every wrapper counts its launches in ``wrapper.launches`` through
:func:`count_launch`. A launch made while this thread captures a CUDA graph
runs nothing yet: inside :func:`launches_recorded` it is tallied instead, and
the graph's owner adds the tally with :func:`credit` at every replay, so the
counts say what the card ran. Inside :func:`calls_recorded` each launch is
listed with the arguments its wrapper passes, and not counted: a measurement
replays a path's own calls through a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--ptxas-options=-v", "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (the CUDA toolkit is needed to build the kernels)")
    return path


def build_library(name: str, source: Path, compile_cmd: Sequence[str], libs: Sequence[str] = (),
                  digest_extra: bytes = b"") -> "tuple[Path, str]":
    """Compile ``source`` with ``compile_cmd`` (compiler and flags) and link
    ``libs`` into ``_build/lib<name>-<digest>.so``, unless that file exists;
    returns its path and the compiler's output ("" when it was built
    already). The digest covers the source, the headers beside it
    (``*.cuh``), the command, ``libs`` and ``digest_extra``, so an edited
    source or header or other flags build anew. The
    compiler writes a temporary file named with this process's id, which
    is then renamed into place: processes that build the same library at
    once each rename a whole file. A failed build raises with the
    compiler's output."""
    headers = b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(
        source.read_bytes() + headers + " ".join([*compile_cmd, *libs]).encode() + digest_extra
    ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib_path.exists():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run([*compile_cmd, "-o", str(tmp), str(source), *libs], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{name}: {compile_cmd[0]} failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib_path)
    return lib_path, log


class KernelLibrary:
    """One ``csrc/<name>.cu`` -> ``_build/lib<name>-<digest>.so`` -> ctypes.

    ``bind(lib)`` sets ``argtypes``/``restype`` of the exported functions,
    once, when the library is first loaded."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None],
                 extra_flags: Sequence[str] = ()):
        self.name = name
        self.source = CSRC_DIR / f"{name}.cu"
        self.flags = (*NVCC_FLAGS, *extra_flags)
        self.build_log = ""  # nvcc's output (ptxas register / shared-memory report)
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def build(self) -> Path:
        """Compile the library if this source and these flags have not been
        built yet; returns its path. Safe to call from several threads."""
        with self._lock:
            path, log = build_library(self.name, self.source, [nvcc_path(), *self.flags])
            self.build_log = log or self.build_log
            return path

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            self._bind(lib)
            self._lib = lib
        return self._lib

    def check(self, err: int) -> None:
        """Raise on a launcher's non-zero ``cudaError_t``."""
        if err != 0:
            msg = self.load().kernel_error_string(err).decode()
            raise RuntimeError(f"{self.name}: kernel launch failed: {msg} ({err})")


_recording = threading.local()


def count_launch(wrapper: Callable, args: tuple = ()) -> None:
    """One launch of ``wrapper``'s kernel with ``args``: counted in
    ``wrapper.launches``, tallied when this thread is inside
    :func:`launches_recorded`, or listed when it is inside
    :func:`calls_recorded`."""
    calls = getattr(_recording, "calls", None)
    if calls is not None:
        import torch

        calls.append((wrapper, tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)))
        return
    tally = getattr(_recording, "tally", None)
    if tally is None:
        wrapper.launches += 1
    else:
        tally[wrapper] += 1


@contextmanager
def launches_recorded() -> Iterator["Counter[Callable]"]:
    """Tally this thread's launches instead of counting them (for a graph
    capture, which launches nothing); yields the tally."""
    if getattr(_recording, "tally", None) is not None:
        raise RuntimeError("launches_recorded: already recording on this thread")
    _recording.tally = Counter()
    try:
        yield _recording.tally
    finally:
        _recording.tally = None


@contextmanager
def calls_recorded() -> Iterator[list]:
    """List this thread's launches as ``(wrapper, args)``, the tensors
    cloned, instead of counting them (to replay a path's own calls through
    a kernel); yields the list."""
    if getattr(_recording, "calls", None) is not None:
        raise RuntimeError("calls_recorded: already recording on this thread")
    _recording.calls = []
    try:
        yield _recording.calls
    finally:
        _recording.calls = None


def credit(tally: "Counter[Callable]") -> None:
    """Count a recorded tally as launched (a graph replay)."""
    for wrapper, n in tally.items():
        wrapper.launches += n
