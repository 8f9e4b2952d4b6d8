"""The seam between the port's Python and its hand-written kernels
(video_gcp_torch/ops/cuda_build.py and csrc/launch.cuh), on the CPU.

- The device rule, the same for K1 forward, K2 backward, K3 and K4: a CPU
  tensor gets the twin's result and counts no launch; any device other than
  CPU or CUDA raises ValueError naming the kernel.
- A library's build key covers the shared header: editing only
  csrc/launch.cuh changes every library's key; an unrelated file, or another
  kernel's source, changes none.
- A launch plan reaches its kernel as its fields in order, one C array per
  plan.
"""
import shutil
from dataclasses import astuple

import numpy as np
import pytest
import torch

from video_gcp_torch.ops import cuda_build, dtw, fused_gn, soft_dtw
from video_gcp_torch.tracing import COUNTS


def _gn(device):
    """x, dy, scale, bias of K2; K1 takes x, scale and bias."""
    rng = np.random.RandomState(0)
    arrays = (rng.randn(2, 4, 4, 16), rng.randn(2, 4, 4, 16), rng.rand(16) + 0.5, rng.randn(16))
    return tuple(torch.tensor(a.astype(np.float32), device=device) for a in arrays)


def _k1_args(device):
    x, _, scale, bias = _gn(device)
    return x, scale, bias, 8


def _cost(device):
    C = np.random.RandomState(1).rand(3, 9, 6).astype(np.float32)
    return torch.tensor(C, device=device), torch.tensor([5, 3, 0], device=device)


KERNELS = {  # kernel: its launch counter, wrapper, twin, and their arguments on a device
    "k1": ("k1.launches", fused_gn.gn_lrelu_fwd, fused_gn.gn_lrelu_reference, _k1_args),
    "k2": ("k2.launches", fused_gn.gn_lrelu_bwd, fused_gn.gn_lrelu_bwd_reference,
           lambda d: (*_gn(d), 8)),
    "k3": ("k3.launches", soft_dtw.k3, soft_dtw.soft_dtw_rows_reference,
           lambda d: (*_cost(d), True)),
    "k4": ("k4.launches", dtw.k4, dtw.alignment_reference, lambda d: (*_cost(d), True)),
}


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_the_device_rule(kernel):
    counter, wrapper, twin, args = KERNELS[kernel]
    before = COUNTS[counter]
    got, want = wrapper(*args("cpu")), twin(*args("cpu"))
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))
    assert COUNTS[counter] == before
    with pytest.raises(ValueError, match="no kernel for meta"):
        wrapper(*args("meta"))


def test_k4_twin_returns_the_accumulated_costs():
    C, ends = _cost("cpu")
    assert torch.equal(dtw.alignment_reference(C, ends, return_dp=True)[2], dtw.min_cumsum(C))


def _keys(csrc):
    return {s: cuda_build.library_path(csrc / s)
            for s in (fused_gn.SOURCE, soft_dtw.SOURCE, dtw.SOURCE)}


def test_the_library_key_covers_the_shared_header(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    keys = _keys(csrc)
    # the key is the files' contents, not where they are
    assert keys == {s: cuda_build.library_path(s) for s in keys}
    assert len(set(keys.values())) == len(keys)
    (csrc / "notes.txt").write_text("not a source\n")
    assert _keys(csrc) == keys
    with open(csrc / soft_dtw.SOURCE, "a") as f:
        f.write("// an edit of one kernel's source\n")
    edited = _keys(csrc)
    assert edited[soft_dtw.SOURCE] != keys[soft_dtw.SOURCE]
    assert {s: k for s, k in edited.items() if s != soft_dtw.SOURCE} == {
        s: k for s, k in keys.items() if s != soft_dtw.SOURCE}
    with open(csrc / "launch.cuh", "a") as f:
        f.write("// an edit of the shared header\n")
    assert all(k != edited[s] for s, k in _keys(csrc).items())


def test_a_plan_reaches_its_kernel_as_its_fields_in_order():
    plans = (fused_gn.launch_plan((16, 32, 32, 16), 4, 8, True), soft_dtw.launch_plan(127, 100),
             dtw.launch_plan(511, 500))
    for plan in plans:
        arr = cuda_build.c_plan(plan)
        assert list(arr) == list(astuple(plan))
        assert cuda_build.c_plan(plan) is arr
