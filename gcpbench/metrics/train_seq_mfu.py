"""The VRNN train step's share of the card's float32 peak (67 TFLOP/s): the
reference's FLOPs of a step (configs/<config>.json, counted at B=1, times B)
times the window's steps, over the unprofiled window's seconds."""
from gcpbench.readers import mfu as read  # noqa: F401
