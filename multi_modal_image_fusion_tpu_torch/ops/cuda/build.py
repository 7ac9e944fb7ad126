"""Build the port's CUDA kernels and load them with ctypes.

Every `csrc/*.cu` file is compiled by its own `nvcc` process, all started
together, for `sm_90a` (Hopper), and the objects are linked into one shared
library with a plain C interface. The library lands in
`multi_modal_image_fusion_tpu_torch/_build/`, named by a hash of the sources
and flags, so an unchanged tree builds once and a changed one never loads a
stale library. Nothing is downloaded and no PyTorch header is compiled.

Each kernel wrapper counts its own launches in `LAUNCHES` (kernel name ->
count), so a caller can show which kernels a run went through. A wrapper
may also count by call site (`conv_valid/forward`, `conv_valid/dx` and
`conv_valid/valid` beside `conv_valid`).
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

LAUNCHES = collections.Counter()

_lib = None
_lock = threading.Lock()


def nvcc_path():
    """nvcc under $CUDA_HOME (default /usr/local/cuda), else on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's kernels are built from csrc/ with "
            "the CUDA toolkit (set CUDA_HOME)")
    return found


def _source_hash(sources):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile csrc/*.cu (one nvcc each, in parallel) and link them into
    _build/libmmif_kernels_<hash>.so; returns the library's path."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    out = BUILD_DIR / f"libmmif_kernels_{_source_hash(sources + headers)}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        for src, proc in zip(sources, procs):
            text, _ = proc.communicate()
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        os.replace(tmp_lib, out)   # atomic: concurrent builds agree
    return out


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def kernel_function(name, argtypes):
    """A C entry point of the library with its argument types declared
    (pointers and the stream as c_void_p, so ctypes never cuts them to 32
    bits) and an int return: the launch's cudaGetLastError()."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(name, err, site=None):
    """Raise if a launch was refused; otherwise count it, under `name` and,
    when a call site is given, also under `name/site`."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1
    if site is not None:
        LAUNCHES[f"{name}/{site}"] += 1


def check_no_grad(name, *tensors):
    """Raise if autograd would need a gradient through a forward-only kernel:
    its output carries no grad_fn, so training through it would silently
    leave the inputs without gradients."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: this kernel is forward-only and an input requires "
            f"grad; run it under torch.no_grad(), or train through the "
            f"training route (ConvLayer takes it when grad is needed; "
            f"ops/cuda/conv_vjp.conv_valid_fast is the differentiable conv)")


def stream_handle(device):
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None
