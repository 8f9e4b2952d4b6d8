"""K2's share of its bound over a train step's 20 GroupNorm sites."""
from gcpbench.readers import k2_roofline as read  # noqa: F401
