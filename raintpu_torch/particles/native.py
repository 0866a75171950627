"""ctypes bindings for the native particle-XML parser.

The port's copy of ``raintpu.particles.native``. The parser's source is
the port's own (``raintpu_torch/csrc/xmlparse.cc``); it is built with
g++ at first use into ``raintpu_torch/_build/`` by
:mod:`raintpu_torch.cuda_build`, keyed by a hash of the source and the
flags. Where it cannot be built (no g++), :func:`available` is False
and :func:`raintpu_torch.particles.xml_io.parse_particles_xml_raw`
parses with ElementTree instead, and counts which parser ran.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

_lib = None
_lib_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    from raintpu_torch import cuda_build

    try:
        lib = cuda_build.load("xmlparse")
    except (OSError, RuntimeError) as e:   # no g++, a failed build
        print(f"[native] the XML parser did not build ({e}); parsing "
              "with ElementTree")
        return None
    lib.rt_parse_xml.restype = ctypes.c_void_p
    lib.rt_parse_xml.argtypes = [ctypes.c_char_p]
    lib.rt_error.restype = ctypes.c_char_p
    lib.rt_error.argtypes = [ctypes.c_void_p]
    lib.rt_num_frames.restype = ctypes.c_int32
    lib.rt_num_frames.argtypes = [ctypes.c_void_p]
    lib.rt_frame_info.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                  ctypes.POINTER(ctypes.c_int32)]
    lib.rt_frame_data.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64)] + \
        [ctypes.POINTER(ctypes.c_double)] * 8
    lib.rt_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def parse_particles_xml_native(path: str) -> List[dict]:
    """Native parse -> same record format as
    xml_io.parse_particles_xml_raw. Raises RuntimeError on failure."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native parser unavailable")
    h = lib.rt_parse_xml(path.encode())
    try:
        err = lib.rt_error(h)
        if err:
            raise RuntimeError(
                f"Reading XML file {path} failed ({err.decode()}); likely "
                "a corrupted particle simulation — delete the simulation "
                "folder and re-run to regenerate.")
        frames = []
        info = (ctypes.c_int32 * 5)()
        for i in range(lib.rt_num_frames(h)):
            lib.rt_frame_info(h, i, info)
            n = int(info[4])
            pid = np.zeros(n, np.int64)
            ip1 = np.zeros((n, 2))
            ip2 = np.zeros((n, 2))
            iw1 = np.zeros(n)
            iw2 = np.zeros(n)
            wp1 = np.zeros((n, 3))
            wp2 = np.zeros((n, 3))
            wd1 = np.zeros(n)
            wd2 = np.zeros(n)
            if n:
                lib.rt_frame_data(
                    h, i,
                    pid.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
                      for a in (ip1, ip2, iw1, iw2, wp1, wp2, wd1, wd2)])
            frames.append({
                "id": int(info[0]), "exposure": int(info[1]),
                "start": int(info[2]), "count": int(info[3]),
                "pid": pid, "ip1": ip1, "ip2": ip2, "iw1": iw1,
                "iw2": iw2, "wp1": wp1, "wp2": wp2,
                "wd1": wd1, "wd2": wd2,
            })
        return frames
    finally:
        lib.rt_free(h)
