"""K3's share of its byte bound in the adaptive train step: each soft-DTW
call reads its cost matrix C [B, r, c] once and writes w once, 2 * B * r *
c * 4 bytes at the HBM's 3.35 TB/s, with B * r * c the cells that the
program's 'binding.cells' counter counted over the profiled pass; over the
device seconds of the profiled kernels named 'soft_dtw_kernel' in that
pass. The bound counts only bytes: the DP's chain of r dependent rows keeps
the kernel far above it."""
from gcpbench import yardstick

K3_KERNEL = "soft_dtw_kernel"
BYTES_PER_CELL = 2 * 4  # read C, write w; float32


def read(run):
    counts = ((run.get("program") or {}).get("profiled") or {}).get("counts", {})
    t = run.get("trace")
    cells = counts.get("binding.cells")
    spent = sum(s for n, s in t.kernels.items() if K3_KERNEL in n) if t else 0.0
    if not cells or not spent:
        return None
    return 100.0 * BYTES_PER_CELL * cells / yardstick.HBM_BYTES_PER_S / spent
