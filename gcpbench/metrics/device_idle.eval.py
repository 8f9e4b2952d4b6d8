"""Share of the profiled top-of-1 call in which no operation ran on the
device."""
from gcpbench.readers import device_idle as read  # noqa: F401
