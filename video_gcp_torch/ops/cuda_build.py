"""Build a CUDA source of `video_gcp_torch/csrc/` into a shared library with a
plain C interface, loaded with ctypes.

The library goes to `video_gcp_torch/_build/<stem>_<hash>.so`, where the hash
covers the source and the flags, so an edited source is rebuilt at its next
use. Compilation is `nvcc -gencode arch=compute_90a,code=sm_90a` (Hopper);
it happens only when a kernel is first launched, never at import.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ptxas report (registers, shared memory, spills) of the last build per source
BUILD_LOGS: dict = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def on_device(x: torch.Tensor):
    """torch.cuda.device(x.device) for a launch, or nothing when x is on the
    current device."""
    if x.device.index is None or x.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)


def stream(x: torch.Tensor) -> int:
    """The current stream of x's device, as a raw handle."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def build(source: str) -> Path:
    """Compile `csrc/<source>` unless its library is already built."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    BUILD_LOGS[source] = proc.stderr
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out
