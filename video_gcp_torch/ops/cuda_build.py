"""Where Python meets the hand-written kernels of `video_gcp_torch/csrc/`.

A kernel module declares its source (`SOURCE`), its entry points' argument
types before the stream (`ENTRY_POINTS`), a frozen launch-plan dataclass and
a plain-PyTorch twin. The rest is here, once: the device rule
(`takes_kernel`), the build with nvcc (sm_90a, at the first launch, never at
import) into `_build/<stem>_<hash>.so`, hashed over the source, the headers
beside it and the flags, the ctypes binding (`load`), the plan as a C int
array (`c_plan`) and the launch (`launch`). Every entry point takes the
stream last and returns a CUDA error code. The CUDA side is
`csrc/launch.cuh`.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import astuple
from pathlib import Path

import torch

from video_gcp_torch import tracing

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SMEM_LIMIT = 232448  # dynamic shared memory a block may use (H100; kSmemLimit)

# ptxas report (registers, shared memory, spills) of the last build per source
BUILD_LOGS: dict = {}
_libraries: dict = {}  # source -> its library, entry points bound


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def takes_kernel(x: torch.Tensor, kernel: str) -> bool:
    """True for a CUDA tensor, which the kernel takes; False for a CPU
    tensor, which the kernel's plain twin takes. Any other device raises
    ValueError naming `kernel`: there is no fallback and no switch."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{kernel}: no kernel for {x.device}")


def on_device(x: torch.Tensor):
    """torch.cuda.device(x.device) for a launch, or nothing when x is on the
    current device."""
    if x.device.index is None or x.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)


def stream(x: torch.Tensor) -> int:
    """The current stream of x's device, as a raw handle."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def library_path(source) -> Path:
    """Where the library of `source` goes: `csrc/<source>`, or `source`
    itself when it is an absolute path (another checkout's source). Its name
    hashes the source, every header (`*.cuh`) in the source's directory and
    the flags."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (src, *sorted(src.parent.glob("*.cuh"))):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:16]}.so"


def build(source) -> Path:
    """Compile `source` (as `library_path` finds it) unless its library is
    already built."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    BUILD_LOGS[source] = proc.stderr
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def load(source, entry_points: dict):
    """The library of `source`, built at first use, with each entry point of
    `entry_points` (name -> the argument types before the stream) bound to
    take the stream last and return an int."""
    lib = _libraries.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        for name, args in entry_points.items():
            fn = getattr(lib, name)
            fn.argtypes = [*args, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _libraries[source] = lib
    return lib


@functools.lru_cache(maxsize=None)
def c_plan(plan):
    """A frozen launch-plan dataclass as the C int array its kernel reads,
    its fields in order; one array per plan."""
    fields = astuple(plan)
    return (ctypes.c_int * len(fields))(*fields)


def launch(source, entry_points: dict, entry: str, x: torch.Tensor, *args,
           counter: str = None) -> None:
    """Call `entry` of `source`'s library with `args` and the current stream
    of x's device, on that device. Raises RuntimeError when it returns a CUDA
    error; then adds one to `tracing.COUNTS[counter]`."""
    fn = getattr(load(source, entry_points), entry)
    with on_device(x):
        err = fn(*args, stream(x))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    if counter is not None:
        tracing.count(counter)
