"""Share of the profiled requests' time in which no operation ran on the
device."""
from gcpbench.readers import device_idle as read  # noqa: F401
