"""The evaluation's share of the card's float32 peak: the reference's FLOPs
of the call's 105 prior forwards (100 samples and 5 plotted ones) over the
window's call seconds."""
from gcpbench.readers import mfu as read  # noqa: F401
