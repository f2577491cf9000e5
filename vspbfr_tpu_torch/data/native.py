"""ctypes bindings for the port's host degradation engine
(`vspbfr_tpu_torch/csrc/host/degrade.cpp`).

Counterpart of `vspbfr_tpu/data/native.py`: the whole blur -> hazy ->
downscale -> noise -> JPEG -> resize chain of a batch in one call, on the
engine's own thread pool, with the JAX engine's parameters, `std::mt19937`
streams and draw order. It links no OpenCV: the filter, the resize and the
JPEG round-trip are its own (the JPEG equal bit for bit to `host_jpeg.py`).

The engine is built at first use, by `g++ -O3 -fPIC -shared -std=c++17
-ffp-contract=off -pthread` (no `-march=native`, so every x86-64 host
computes the same bits), into `<repo>/build/vspbfr_tpu_torch/host/<key>/`,
where the key hashes the source, the flags and the compiler's version. A
missing `g++` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host" / "degrade.cpp"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "vspbfr_tpu_torch" / "host")
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off",
         "-pthread")
ABI_VERSION = 2

# the engine loaded in this process (a cache of the build, not state)
_LIB: ctypes.CDLL | None = None


def _compiler() -> tuple[str, str]:
    """g++'s path and its version line."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host degradation engine "
                           "cannot be built")
    version = subprocess.run([gxx, "--version"], capture_output=True,
                             text=True, check=True).stdout.splitlines()[0]
    return gxx, version


def build_key(compiler_version: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(compiler_version.encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """The engine's shared library, built first if its key (source, flags
    and compiler) is new, one builder at a time under a lock in the build
    directory."""
    gxx, version = _compiler()
    out_dir = BUILD_ROOT / build_key(version)
    so = out_dir / "libvspbfr_host_degrade.so"
    if so.is_file():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.is_file():
            with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
                tmp_so = Path(tmp) / so.name
                cmd = [gxx, *FLAGS, str(SOURCE), "-o", str(tmp_so)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                (out_dir / "build.log").write_text(
                    " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
                if proc.returncode != 0:
                    raise RuntimeError("g++ failed:\n" + proc.stderr[-4000:])
                os.replace(tmp_so, so)
    return so


def load() -> ctypes.CDLL:
    """The engine, built if needed and loaded once per process."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(library_path()))
    lib.vspbfr_degrade_abi_version.restype = ctypes.c_int
    lib.vspbfr_degrade_abi_version.argtypes = []
    if lib.vspbfr_degrade_abi_version() != ABI_VERSION:
        raise RuntimeError("host degradation engine: ABI version mismatch")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vspbfr_degrade_batch.restype = i
    lib.vspbfr_degrade_batch.argtypes = [p, p, i, i, i, p, i]
    lib.vspbfr_jpeg_roundtrip.restype = i
    lib.vspbfr_jpeg_roundtrip.argtypes = [p, p, i, i, i]
    _LIB = lib
    return lib


def degrade_batch(gt: np.ndarray, seeds: np.ndarray,
                  n_threads: int | None = None) -> np.ndarray:
    """Degrade (N, H, W, 3) float32 [0,1] GT images; one seed per image."""
    lib = load()
    gt = np.ascontiguousarray(gt, dtype=np.float32)
    if gt.ndim != 4 or gt.shape[3] != 3:
        raise ValueError(f"expected (N, H, W, 3) GT, got {gt.shape}")
    n, h, w, _ = gt.shape
    seeds = np.ascontiguousarray(seeds, dtype=np.uint64)
    if seeds.shape != (n,):
        raise ValueError(f"{seeds.shape[0]} seeds for {n} images")
    out = np.empty_like(gt)
    if n_threads is None:
        n_threads = min(n, os.cpu_count() or 1)
    rc = lib.vspbfr_degrade_batch(gt.ctypes.data, out.ctypes.data, n, h, w,
                                  seeds.ctypes.data, n_threads)
    if rc != 0:
        raise RuntimeError(f"native degrade failed with code {rc}")
    return out


def jpeg_roundtrip(img_u8: np.ndarray, quality: int) -> np.ndarray:
    """The engine's JPEG round-trip of an (H, W, 3) uint8 image (the same
    function as `host_jpeg.jpeg_roundtrip`)."""
    lib = load()
    img = np.ascontiguousarray(img_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected uint8 (H, W, 3), got {img.dtype} "
                         f"{img.shape}")
    out = np.empty_like(img)
    lib.vspbfr_jpeg_roundtrip(img.ctypes.data, out.ctypes.data,
                              img.shape[0], img.shape[1], int(quality))
    return out
