"""Build and load the port's CUDA kernels (K1 dense conv and its fused
epilogue form K1e, K2 multi-dilation conv, K3 phase interleave, K4 phase
gather, K5 fused SMART core, K6 styled epilogue, K7 bias + leaky ReLU, K8
the interleave's stack and repeat forms, K9 stripe conv and K10 its
in-kernel padding variants).

No JAX counterpart: the JAX package's Pallas kernels are compiled by XLA.
Here the sources under `vspbfr_tpu_torch/csrc/` are compiled by `nvcc` for
Hopper (`sm_90a`) into ONE shared library with a plain C interface, loaded
with `ctypes`: one `nvcc -c` per source, all started together, then one
link. The build runs at first use, into
`<repo>/build/vspbfr_tpu_torch/<key>/`, where the key is a hash of the
sources and the compiler flags, so a changed source rebuilds and an
unchanged one loads the library already built. A missing `nvcc` or a failed
build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "vspbfr_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, w, in_scale, y, dtype, B, H, W, Ci, Co, KH, KW, py0, px0, OH, OW, stream
    "vspbfr_dense_conv": [_P, _P, _P, _P] + [_I] * 12 + [_P],
    # x, w, in_scale, y, out_scale, noise, bias, post0, post1, noise2, bias2,
    # mask, n_post, act, act2, dtype, B, H, W, Ci, Co, KH, KW, py0, px0, OH,
    # OW, stream
    "vspbfr_dense_conv_epi": [_P] * 12 + [_I] * 15 + [_P],
    # x, ws (one pointer a branch), in_scale, out_scale, y, dtype, B, H, W,
    # Ci, n, dils, cos, stream
    "vspbfr_dilated_multi_conv": [_P, ctypes.POINTER(_P)] + [_P] * 3
    + [_I] * 6 + [ctypes.POINTER(_I), ctypes.POINTER(_I), _P],
    # x, y, B, h, w, inner_bytes, unit_bytes, stream
    "vspbfr_d2s": [_P, _P] + [_I] * 5 + [_P],
    # x, y, B, h, w (the output grid), inner_bytes, unit_bytes, stream
    "vspbfr_s2d": [_P, _P] + [_I] * 5 + [_P],
    # x, sty, wb, dv, wf, y, dtype, plan (ops/smart.py PLAN_FIELDS), stream
    "vspbfr_smart_fused": [_P] * 6 + [_I, ctypes.POINTER(_I), _P],
    # one packed block (`launcher`: ops/epilogue.py LAUNCH_FIELDS), stream
    "vspbfr_conv_epilogue": [ctypes.c_char_p, _P],
    # one packed block (ops/fused_act.py LAUNCH_FIELDS), stream
    "vspbfr_fused_lrelu": [ctypes.c_char_p, _P],
    # x, y, B, h, w, inner_bytes, unit_bytes, stream (both K8 forms)
    "vspbfr_interleave_stack": [_P, _P] + [_I] * 5 + [_P],
    "vspbfr_interleave_repeat": [_P, _P] + [_I] * 5 + [_P],
    # x, wt, y, dtype, load, plan (ops/stripe_conv.py PLAN_FIELDS), stream
    "vspbfr_stripe_conv": [_P] * 3 + [_I, _I, ctypes.POINTER(_I), _P],
}


class KernelLibrary:
    """The loaded kernels plus what their build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, log: str,
                 build_seconds: float):
        self.lib = lib
        self.path = path
        self.log = log
        self.build_seconds = build_seconds
        # each entry point looked up once, with its argument types set
        self.entries = {}
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self.entries[name] = fn

    def call(self, name: str, *args) -> None:
        """Launch through the C entry point; raise if the launch failed."""
        err = self.entries[name](*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")


# the library loaded in this process (a cache of the build, not state:
# loading it again would map the same file)
_LIBRARY: KernelLibrary | None = None


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME
    nvcc = Path(home or "/nonexistent") / "bin" / "nvcc"
    if not nvcc.is_file():
        raise RuntimeError(
            f"nvcc not found (CUDA_HOME={home!r}); the CUDA kernels cannot be "
            "built")
    return str(nvcc)


def load_library() -> KernelLibrary:
    """Build the kernel library if its key is new, then load it (once per
    process)."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    out_dir = BUILD_ROOT / build_key()
    so = out_dir / "libvspbfr_kernels.so"
    log_path = out_dir / "build.log"
    t0 = time.perf_counter()
    if not so.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            objs, procs = [], []
            for cu in sorted(CSRC.glob("*.cu")):
                obj = Path(tmp) / (cu.stem + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
                       str(obj), str(cu)]
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
                objs.append(str(obj))
            tmp_so = Path(tmp) / so.name
            link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so), *objs]
            log, failed = [], []
            for cmd, proc in procs:
                out, _ = proc.communicate()
                log.append(" ".join(cmd) + "\n" + out)
                if proc.returncode != 0:
                    failed.append(out)
            if not failed:
                proc = subprocess.run(link, capture_output=True, text=True)
                log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
                if proc.returncode != 0:
                    failed.append(proc.stderr)
            log_path.write_text("".join(log))
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-4000:])
            shutil.move(str(tmp_so), so)
    log = log_path.read_text() if log_path.is_file() else ""
    _LIBRARY = KernelLibrary(ctypes.CDLL(str(so)), so, log,
                             time.perf_counter() - t0)
    return _LIBRARY


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return code


def check_cuda_inputs(name: str, *tensors) -> None:
    """The checks every kernel wrapper makes before a launch: same CUDA
    device and dtype, contiguous. Gradients do not pass through here: the
    wrappers' `torch.autograd.Function`s call the kernels with grad mode
    off and launch kernels again in their backward."""
    ref = tensors[0]
    for t in tensors:
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError(f"{name}: tensors on {t.device} and {ref.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{name}: dtypes {t.dtype} and {ref.dtype} differ")
        if not t.is_contiguous():
            raise ValueError(f"{name}: input of shape {tuple(t.shape)} is not "
                             "contiguous")
    dtype_code(ref)


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def multiprocessors(device: torch.device) -> int:
    """The multiprocessors of a CUDA device (a launch plan's input)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# the current stream's handle by device index without building a Stream
# object (what `torch.cuda.current_stream(i).cuda_stream` returns)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def launcher(name: str, fields):
    """(pack, launch): a lean launch of entry point `name` for the
    streaming kernels (K6, K7), whose host time is a large part of a call.
    The entry takes one block of arguments and the stream: two ctypes
    arguments instead of twenty. fields: the C struct the entry reads, as
    (name, `struct` format) pairs in order; `pack(*values)` packs values
    in that order (pointers as ints, 0 for an absent one). The other
    entries keep `KernelLibrary.call`: a conv's launch takes a tenth of a
    millisecond or more on the device, which hides its host time.
    `launch(x, block)`
    looks the entry up once (with the library's build), reads the current
    stream of x's device by index (entering that device only when it is
    not the current one) and raises on a non-zero launch code."""
    entry = None

    def launch(x, block: bytes) -> None:
        nonlocal entry
        if entry is None:
            entry = load_library().entries[name]
        dev = x.get_device()
        if dev != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return launch(x, block)
        err = entry(block, _raw_stream(dev) if _raw_stream is not None
                    else torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")

    return struct.Struct("<" + "".join(f for _, f in fields)).pack, launch


def operand_code(name: str, x, operands):
    """The one dtype code of the small operands a streaming kernel reads
    beside x (each rounded to x's dtype as it is read), and the operands,
    each contiguous on x's device (the caller holds them until the launch):
    operands that share x's dtype or float32 are read as they are; mixed
    dtypes, or bfloat16 beside a float32 x, are all cast to x's (one cast
    each). Raises for another dtype or device."""
    dtype = None
    for t in operands:
        if t is not None:
            if dtype is None:
                dtype = t.dtype
            elif t.dtype != dtype:
                dtype = None
                break
    else:
        if dtype not in (x.dtype, torch.float32, None):
            if dtype not in DTYPE_CODES:
                raise TypeError(f"{name}: operands take float32 or bfloat16, "
                                f"got {dtype}")
            dtype = None
    if dtype is None and any(t is not None for t in operands):
        operands = [None if t is None else t.to(x.dtype) for t in operands]
    code = DTYPE_CODES[x.dtype if dtype is None else dtype]
    dev = x.get_device()
    out = []
    for t in operands:
        if t is not None:
            if t.get_device() != dev:
                raise ValueError(f"{name}: tensors on {t.device} and "
                                 f"{x.device}")
            if not t.is_contiguous():
                t = t.contiguous()
        out.append(t)
    return code, out


def addr(t) -> int:
    """t's data pointer, 0 for None (a packed launch's absent operand)."""
    return 0 if t is None else t.data_ptr()
