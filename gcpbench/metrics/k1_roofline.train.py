"""K1's share of its bound over a train step's 20 GroupNorm sites: the sum
of the sites' least seconds (yardstick.k1_bound_s) over the profiled
kernels' device seconds."""
from gcpbench.readers import k1_roofline as read  # noqa: F401
