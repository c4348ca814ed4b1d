"""The JAX package's host libraries, made whole before a port test holds the
port to them.

``playground3d_tpu/data/native.py`` and ``data/avdecode.py`` run ``make -C
native`` in place the first time a process uses them, and a loader that
finds its library missing or half written (another test process building it
at that moment) gives up for the life of the process: ``data.native`` then
takes its numpy paths, ``data.avdecode.AvReader`` raises, and
``data.video`` probes another decoder at import (cv2 where it is installed,
whose ``resize`` differs from the package's own). A port test compared
against the JAX package would then be compared against whichever path won
the race. The helpers here take that race out of the port's tests, and
change nothing in the JAX package:

* :func:`jax_library` loads one JAX loader's library under an inter-process
  lock (``fcntl.flock`` on ``native/Makefile``); where the library is
  missing or stale, or does not load, it builds it with ``native/Makefile``
  in a temporary directory beside it and renames the whole file into place,
  then clears the loader's cached failure (``_tried``) and loads again;
* :func:`jax_video` does so for both libraries and probes ``data.video``'s
  decoder again, as its import would have with the libraries whole.

The lock orders the port's helpers only. The JAX package's own loaders,
and the JAX tests that run them in other test processes
(``tests/test_native.py``, ``tests/test_avdecode.py``), still run ``make``
in place without it, so a link that writes the library in place while a
helper renames a whole one over it can still leave a truncated file: the
race is rarer, not gone. A helper whose load fails therefore builds and
loads once more, and once more again after a short wait, before it raises.

The tests below hold the helpers to that.
"""

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SOURCES = {"libframepipe.so": "framepipe.cc", "libavdecode.so": "avdecode.cc"}
RETRY_WAIT_S = 2.0


def _target_of(module) -> str:
    return os.path.basename(module._LIB_PATH)


def build_whole(target: str, native_dir: str = NATIVE_DIR) -> str:
    """Build ``target`` with ``native_dir``'s Makefile in a temporary
    directory beside it and rename the whole file into ``native_dir``:
    a process that loads it meanwhile sees the old file or the new one."""
    tmp = tempfile.mkdtemp(prefix=".build-", dir=native_dir)
    try:
        for name in ("Makefile", _SOURCES[target]):
            shutil.copy2(os.path.join(native_dir, name), tmp)
        subprocess.run(["make", "-C", tmp, "-s", target], check=True, capture_output=True, timeout=600)
        out = os.path.join(native_dir, target)
        os.replace(os.path.join(tmp, target), out)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _fresh(path: str, source: str) -> bool:
    return os.path.exists(path) and os.path.getmtime(source) <= os.path.getmtime(path)


def jax_library(module) -> ctypes.CDLL:
    """``module``'s (``playground3d_tpu.data.native`` or ``.avdecode``)
    library, loaded through its own loader; raises if it does not load
    after three builds, the last after a short wait."""
    if module._lib is not None:
        return module._lib
    target = _target_of(module)
    path = os.path.join(NATIVE_DIR, target)
    source = os.path.join(NATIVE_DIR, _SOURCES[target])
    with open(os.path.join(NATIVE_DIR, "Makefile")) as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for attempt in range(3):
            if attempt == 2:
                time.sleep(RETRY_WAIT_S)  # an in-place build of the JAX package's own may be under way
            if attempt or not _fresh(path, source):
                build_whole(target)
            module._tried = False
            lib = module._load()
            if lib is not None:
                return lib
    raise AssertionError(f"{module.__name__}: {target} does not load after three whole builds")


def jax_video():
    """``playground3d_tpu.data.video`` with the JAX package's host libraries
    loaded and its decoder probed with them in place."""
    import playground3d_tpu.data.avdecode as ja
    import playground3d_tpu.data.native as jn
    from playground3d_tpu_torch.data import avdecode

    jax_library(jn)
    if avdecode.available():  # native/Makefile builds libavdecode where pkg-config finds FFmpeg
        jax_library(ja)
    import playground3d_tpu.data.video as jv

    jv.DECODER = jv._probe_decoder()
    return jv


def test_whole_build_lands_in_place_and_leaves_no_scratch(tmp_path):
    for name in ("Makefile", "framepipe.cc"):
        shutil.copy2(os.path.join(NATIVE_DIR, name), tmp_path)
    out = build_whole("libframepipe.so", str(tmp_path))
    assert out == str(tmp_path / "libframepipe.so")
    assert hasattr(ctypes.CDLL(out), "fp_resize_half")
    assert sorted(os.listdir(tmp_path)) == ["Makefile", "framepipe.cc", "libframepipe.so"]


def test_a_loader_that_gave_up_loads_again():
    """A JAX loader that lost the build race (``_tried`` set, no library)
    loads after :func:`jax_library`, and its entry points take the native
    path: ``resize_half`` equals its numpy twin in the port."""
    import playground3d_tpu.data.native as jn
    from playground3d_tpu_torch.data.native import resize_half_plain

    jn._lib, jn._tried = None, True
    assert not jn.native_available()
    lib = jax_library(jn)
    assert jn.native_available() and jn._lib is lib
    f = np.random.default_rng(0).integers(0, 256, (6, 10, 3), dtype=np.uint8)
    np.testing.assert_array_equal(jn.resize_half(f), resize_half_plain(f))


def test_video_decoder_is_probed_again():
    """``data.video`` imported while libavdecode was missing keeps another
    decoder; :func:`jax_video` probes it again with the library whole."""
    import playground3d_tpu.data.video as jv
    from playground3d_tpu_torch.data import avdecode

    jv.DECODER = "lost-the-race"
    assert jax_video() is jv
    assert jv.DECODER == ("lav" if avdecode.available() else jv._probe_decoder())


def test_a_load_that_fails_twice_is_tried_again_after_a_wait(monkeypatch):
    """A load that fails after the first whole build (a JAX loader's
    in-place build wrote over it) is built and loaded again, then once more
    after the wait; three failures raise."""
    import sys
    import types

    this = sys.modules[__name__]
    builds, waits = [], []
    monkeypatch.setattr(this, "build_whole", lambda target: builds.append(target))
    monkeypatch.setattr(this, "_fresh", lambda path, source: False)
    monkeypatch.setattr(time, "sleep", waits.append)

    def loader(succeed_at):
        tries = []
        module = types.SimpleNamespace(__name__="fake", _LIB_PATH="native/libframepipe.so", _lib=None, _tried=True)

        def load():
            assert module._tried is False
            tries.append(1)
            return "lib" if len(tries) == succeed_at else None

        module._load = load
        return module

    assert jax_library(loader(3)) == "lib"
    assert builds == ["libframepipe.so"] * 3 and waits == [RETRY_WAIT_S]
    builds.clear()
    try:
        jax_library(loader(4))
    except AssertionError as e:
        assert "three whole builds" in str(e)
    else:
        raise AssertionError("a library that never loads was returned")
    assert len(builds) == 3
