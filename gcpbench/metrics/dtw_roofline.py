"""The eval DTW's share of its bound: reading the cost matrix C [B, nodes,
frames] once and writing each frame's match, at 3.35 TB/s, over the DTW
spans' seconds. It counts the same work whatever implements the DTW."""
from gcpbench.readers import dtw_roofline as read  # noqa: F401
