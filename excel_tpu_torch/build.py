"""Build the port's CUDA kernels with nvcc and bind them with ctypes; build
the host lattice CRF with g++.

Each source `csrc/<name>.cu` is compiled on its own into
`_build/lib<name>-<hash>.so`, a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). The hash covers the source
and every header in `csrc/`, so an edited source builds anew and a stale
library is never loaded. Libraries are built at first use; `build()` builds
several at once, one nvcc process per source, all started together.

The host libraries, `native/densecrf.cpp` (the permutohedral-lattice dense
CRF) and `native/jpeg.cpp` (the JPEG decoder), are compiled by
`build_host(name)` into `_build/<library>-<hash>.so` (`HOST_SOURCES`), the
hash covering the source, the flags and the host's CPU (the library is
built for it with -march=native).

Every kernel wrapper launches through `launch(symbol, tensor, *args)`: the
C entry point, its arguments, and the current CUDA stream of the tensor's
device appended last. A launch that returns a CUDA error raises naming the
entry point; one that does not adds 1 to the profiling counter
`launch.<symbol>` (`utils.profiling`: counted only while it is on).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time

import torch

from .utils import profiling

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
# host source name -> (its file, its library's name)
HOST_SOURCES = {"densecrf": (os.path.join(NATIVE, "densecrf.cpp"),
                             "libexcelcrf"),
                "jpeg": (os.path.join(NATIVE, "jpeg.cpp"), "libexceljpeg")}
GXX = "g++"
GXX_FLAGS = ("-O3", "-std=c++17", "-funroll-loops", "-shared", "-fPIC")
# tried in turn: native SIMD with OpenMP, OpenMP alone, neither (the
# lattice's pragmas degrade to serial loops; its results are equal for any
# thread count)
GXX_EXTRA = (("-march=native", "-fopenmp"), ("-fopenmp",), ())
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PLAIN_ATTN = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_SURGERY_ATTN = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_DIFFUSE = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
_PAD_CLAMP = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
_AFFINITY = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P]
_VALID_STEP = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
_VALID_RESIDENT = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                   _I, _P]
_UPSAMPLE_BWD = [_P, _P, _I, _I, _I, _I, _I, _P]
_LAYER_NORM = [_P, _P, _P, _P, _P, _P, _I, _I, _F, _P]
_QKV_HEADS = [_P, _P, _P, _I, _I, _I, _I, _P]
_QKV_HEADS_ROPE = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
_SWIGLU_GATE = [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P]
_FC_ACT = [_P, _P, _P, _I, _I, _I, _P]
# source name -> {C entry point: argument types}; every entry point returns
# the cudaError_t of its launch as an int
ENTRY_POINTS = {
    "attention_plain": {"excel_plain_attention_f32": _PLAIN_ATTN,
                        "excel_plain_attention_bf16": _PLAIN_ATTN},
    "attention_surgery": {"excel_surgery_attention_f32": _SURGERY_ATTN,
                          "excel_surgery_attention_bf16": _SURGERY_ATTN},
    "par_diffuse": {"excel_par_diffuse_f32": _DIFFUSE,
                    "excel_par_diffuse_bf16": _DIFFUSE},
    "par_pad_clamp": {"excel_pad_clamp_f32": _PAD_CLAMP,
                      "excel_pad_clamp_bf16": _PAD_CLAMP},
    "par_affinity": {"excel_par_affinity_bf16": _AFFINITY,
                     "excel_par_affinity_direct_bf16": _AFFINITY},
    "par_diffuse_valid": {
        "excel_par_diffuse_valid_step_bf16": _VALID_STEP,
        "excel_par_diffuse_valid_resident_bf16": _VALID_RESIDENT},
    "upsample_linear": {"excel_upsample_linear_bwd_f32": _UPSAMPLE_BWD},
    "layer_norm": {"excel_layer_norm_f32": _LAYER_NORM,
                   "excel_layer_norm_bf16": _LAYER_NORM},
    "qkv_heads": {"excel_qkv_heads_f32": _QKV_HEADS,
                  "excel_qkv_heads_bf16": _QKV_HEADS,
                  "excel_qkv_heads_rope_f32": _QKV_HEADS_ROPE,
                  "excel_qkv_heads_rope_bf16": _QKV_HEADS_ROPE},
    "swiglu_gate": {"excel_swiglu_gate_f32": _SWIGLU_GATE,
                    "excel_swiglu_gate_bf16": _SWIGLU_GATE},
    "fc_act": {"excel_fc_act_f32": _FC_ACT, "excel_fc_act_bf16": _FC_ACT},
}
# C entry point -> its source name
_SOURCE = {symbol: name for name, entries in ENTRY_POINTS.items()
           for symbol in entries}
# the tensor types of the kernels that take two, and the suffix of each
# one's entry point
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

_loaded: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc") or (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None)
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == name + ".cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names=tuple(ENTRY_POINTS)) -> dict[str, float]:
    """Compile every named source whose library is missing, in parallel.

    Returns {name: seconds} (0.0 for a library already built). The
    compiler's resource report (-Xptxas -v) is kept beside each library as
    `<library>.log`. Raises with nvcc's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        with open(out + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def sass(name: str) -> str:
    """The SASS of `csrc/<name>.cu`'s library (`cuobjdump -sass`, the tool
    beside nvcc), building the library first if needed."""
    build((name,))
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", library_path(name)],
                          capture_output=True, text=True, check=True).stdout


def _host_cpu() -> str:
    """The CPU a -march=native build is for: a checkout shared by two kinds
    of host builds a library for each."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")), "")
    except OSError:
        return platform.machine()


def host_library_path(name: str = "densecrf") -> str:
    source, lib = HOST_SOURCES[name]
    h = hashlib.sha256(" ".join(GXX_FLAGS + sum(GXX_EXTRA, ())).encode())
    h.update(_host_cpu().encode())
    with open(source, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"{lib}-{h.hexdigest()[:12]}.so")


def build_host(name: str = "densecrf") -> float:
    """Compile the host library `name` of HOST_SOURCES unless it is built;
    returns the seconds it took (0.0 for a library already built). Each
    attempt of the flag ladder writes a pid-suffixed file that is renamed
    into place, so processes building at once never load a half-written
    library. Raises with g++'s output when every attempt fails."""
    source = HOST_SOURCES[name][0]
    out = host_library_path(name)
    if os.path.exists(out):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        for extra in GXX_EXTRA:
            proc = subprocess.run([GXX, *extra, *GXX_FLAGS, "-o", tmp,
                                   source], capture_output=True, text=True)
            if proc.returncode == 0:
                os.replace(tmp, out)
                return time.perf_counter() - t0
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    raise RuntimeError(f"{GXX} failed to build {source} "
                       f"(rc {proc.returncode}):\n{proc.stderr}")


def load(name: str, symbol: str):
    """The C entry point `symbol` of `csrc/<name>.cu` as a ctypes function,
    building its library first if needed."""
    with _lock:
        if (name, symbol) not in _loaded:
            build((name,))
            fn = getattr(ctypes.CDLL(library_path(name)), symbol)
            fn.argtypes = ENTRY_POINTS[name][symbol]
            fn.restype = ctypes.c_int
            _loaded[name, symbol] = fn
        return _loaded[name, symbol]


def check(rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {rc}")


def typed(stem: str, dtype: torch.dtype) -> str:
    """The entry point `<stem>_f32` or `<stem>_bf16` for `dtype`."""
    return f"{stem}_{SUFFIX[dtype]}"


def launch(symbol: str, tensor: torch.Tensor, *args) -> None:
    """Call the C entry point `symbol` with `args` and the current CUDA
    stream of `tensor`'s device; raise on a CUDA error, else count the
    launch as `launch.<symbol>`."""
    stream = torch.cuda.current_stream(tensor.device).cuda_stream
    check(load(_SOURCE[symbol], symbol)(*args, stream), symbol)
    profiling.count("launch." + symbol)
