"""Share of the VRNN's profiled steps in which no operation ran on the
device: 1 - the union of device-operation intervals over the pass's wall
time."""
from gcpbench.readers import device_idle as read  # noqa: F401
