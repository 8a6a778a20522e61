"""ctypes binding of the port's FFmpeg library, ``libvideodec``, built with
g++ from ``videodec.cpp`` beside this file at first use:
:class:`VideoDecoderI420` decodes a video straight to ROI-cropped, resized
planar I420 rows, and :func:`video_meta` reads a stream's frame count, fps,
size and pixel format without cv2.

:func:`ffmpeg_available` is the platform test: whether ``pkg-config`` finds
FFmpeg's development files, asked once per process. Callers use the library
only where it says yes. The library builds into
``aicity_action_tpu_torch/_build/native/`` under a name keyed by its source
and flags, so an edited source is rebuilt; the compiler's output goes to
``build.log`` there. A failed build or load raises ``RuntimeError`` with the
log's tail: nothing here returns ``None`` for a caller to fall back on.
Calls through ``ctypes.CDLL`` release the GIL, so decoders in several
threads overlap.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import NamedTuple, Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build", "native")
CXXFLAGS = ("-O3", "-fPIC", "-fopenmp", "-march=native", "-std=c++17",
            "-shared")
FFMPEG_PACKAGES = ("libavcodec", "libavformat", "libavutil", "libswscale")

_lock = threading.RLock()  # load() asks pkg-config under it
_lib: list = []  # [the loaded library] once loaded
_pkg_config: list = []  # [(returncode, stdout, stderr)] once asked

_u8p = ctypes.POINTER(ctypes.c_uint8)
_int = ctypes.c_int
# (restype, argtypes) of every entry point
_SIGNATURES = {
    "vdec_meta": (_int, [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                         ctypes.POINTER(ctypes.c_double),
                         ctypes.POINTER(_int), ctypes.POINTER(_int),
                         ctypes.POINTER(_int)]),
    "vdec_open": (ctypes.c_void_p, [ctypes.c_char_p] + [_int] * 6),
    "vdec_read_i420": (_int, [ctypes.c_void_p, _u8p]),
    "vdec_seek": (_int, [ctypes.c_void_p, ctypes.c_int64]),
    "vdec_skip": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int64]),
    "vdec_close": (None, [ctypes.c_void_p]),
}


def _log(text: str) -> None:
    with open(os.path.join(BUILD_DIR, "build.log"), "a") as f:
        f.write(text)


def _tail(text: str, lines: int = 20) -> str:
    return "\n".join(text.strip().splitlines()[-lines:])


def _ask_pkg_config() -> tuple[int, str, str]:
    """``pkg-config --cflags --libs`` of FFmpeg's four libraries, run once
    per process: ``(returncode, stdout, stderr)``."""
    with _lock:
        if not _pkg_config:
            cmd = ["pkg-config", "--cflags", "--libs", *FFMPEG_PACKAGES]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=60)
                _pkg_config.append((res.returncode, res.stdout, res.stderr))
            except FileNotFoundError:
                _pkg_config.append((127, "", "pkg-config is not installed"))
        return _pkg_config[0]


def ffmpeg_available() -> bool:
    """Whether ``pkg-config`` finds FFmpeg's development files, so that the
    library can be built here."""
    return _ask_pkg_config()[0] == 0


def ffmpeg_flags() -> list[str]:
    """``pkg-config --cflags --libs`` of FFmpeg's four libraries; raises
    ``RuntimeError`` with pkg-config's words where they are missing."""
    rc, out, err = _ask_pkg_config()
    if rc:
        raise RuntimeError(
            "FFmpeg's development files (" + ", ".join(FFMPEG_PACKAGES)
            + ") are not installed; `pkg-config --cflags --libs "
            + " ".join(FFMPEG_PACKAGES) + "` said:\n" + _tail(err))
    return out.split()


def _build() -> str:
    """Path of ``libvideodec.so``, compiled from ``videodec.cpp`` unless a
    build of this source with these flags exists."""
    src = os.path.join(_DIR, "videodec.cpp")
    os.makedirs(BUILD_DIR, exist_ok=True)
    try:
        extra = ffmpeg_flags()
    except RuntimeError as e:
        _log(f"$ pkg-config for libvideodec.so\n{e}\n")
        raise
    with open(src, "rb") as f:
        key = hashlib.sha1(f.read() + " ".join(CXXFLAGS + tuple(extra))
                           .encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"libvideodec-{key}.so")
    if os.path.exists(out):
        return out
    # a private name, then an atomic rename: processes that build at once
    # never load a half-written library
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}"
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp, src, *extra]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"building libvideodec.so: no C++ compiler "
                           f"({cmd[0]})") from e
    _log(f"$ {' '.join(cmd)}\n{res.stdout}{res.stderr}rc={res.returncode}\n")
    if res.returncode:
        raise RuntimeError(
            f"building libvideodec.so failed (rc {res.returncode}); tail of "
            f"{os.path.join(BUILD_DIR, 'build.log')}:\n"
            + _tail(res.stdout + res.stderr))
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """``libvideodec``, built and loaded once per process; raises
    ``RuntimeError`` where it cannot be."""
    with _lock:
        if not _lib:
            path = _build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(f"loading {path} failed: {e}") from e
            for fn, (restype, argtypes) in _SIGNATURES.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _lib.append(lib)
        return _lib[0]


# -------------------------------------------------------------- videodec

class VideoMeta(NamedTuple):
    frames: int
    fps: float
    width: int
    height: int
    yuv420p: bool


def video_meta(path: str) -> Optional[VideoMeta]:
    """FFmpeg's reading of ``path`` (frame count and fps as cv2's
    ``CAP_PROP_FRAME_COUNT`` / ``CAP_PROP_FPS`` give them), or None where
    FFmpeg cannot open it or it has no video stream."""
    lib = load()
    n, fps = ctypes.c_int64(), ctypes.c_double()
    w, h, yuv = _int(), _int(), _int()
    if lib.vdec_meta(path.encode(), ctypes.byref(n), ctypes.byref(fps),
                     ctypes.byref(w), ctypes.byref(h), ctypes.byref(yuv)):
        return None
    return VideoMeta(n.value, fps.value, w.value, h.value, bool(yuv.value))


class VideoDecoderI420:
    """Sequential, seekable decoder of ROI-cropped, resized planar I420
    frames: ``read(out)`` fills a u8 ``[size*3//2, size]`` row.

    ``roi_px`` ``(x1, y1, x2, y2)`` in source pixels (None: the whole
    frame); the decoder rounds x1, y1 and the crop's width and height down
    to even. Raises ``RuntimeError`` where the library cannot be built or
    FFmpeg cannot open the file as a yuv420p stream.
    """

    _h = None

    def __init__(self, path: str, size: int,
                 roi_px: Optional[tuple[int, int, int, int]] = None):
        self._lib = load()
        x1, y1, x2, y2 = roi_px if roi_px is not None else (0, 0, 0, 0)
        self._h = self._lib.vdec_open(path.encode(), size, size, int(x1),
                                      int(y1), int(x2), int(y2))
        if not self._h:
            raise RuntimeError(f"vdec_open failed for {path} (size {size}, "
                               f"roi {roi_px})")
        self.size = size

    def read(self, out: np.ndarray) -> bool:
        """Decode the next frame into ``out`` (u8 ``[size*3//2, size]``,
        C-contiguous). Returns False at EOF."""
        s = self.size
        if out.shape != (s * 3 // 2, s) or out.dtype != np.uint8 or \
                not out.flags.c_contiguous:
            raise ValueError(f"expected a C-contiguous u8 [{s * 3 // 2}, "
                             f"{s}] row, got {out.dtype} {out.shape}")
        r = self._lib.vdec_read_i420(self._h, out.ctypes.data_as(_u8p))
        if r < 0:
            raise RuntimeError(f"vdec_read_i420 error {r}")
        return bool(r)

    def seek(self, frame_idx: int) -> bool:
        """Position so that the next read returns ``frame_idx``. False
        where the container refuses (the caller skips instead)."""
        return self._lib.vdec_seek(self._h, int(frame_idx)) == 0

    def skip(self, n: int) -> int:
        """Decode and discard ``n`` frames without crop or scale work;
        returns the frames skipped (fewer at EOF)."""
        return int(self._lib.vdec_skip(self._h, int(n)))

    def close(self) -> None:
        if self._h:
            self._lib.vdec_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
