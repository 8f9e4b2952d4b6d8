from video_gcp_torch.data.datasets import (
    FolderSplitVarLenVideoDataset,
    GlobalSplitVarLenVideoDataset,
    MazeGlobalSplitVarLenVideoDataset,
    MazeTopRenderedGlobalSplitVarLenVideoDataset,
    RandomVideoDataset,
    VarLenVideoDataset,
)
from video_gcp_torch.data.loader import DataLoader
