"""nav_9rooms dataset config (reference: gcp/datasets/configs/nav_9rooms.py).

Images are re-rendered top-down from the (x, y) states through the renderer
that the control-time env uses (MazeTopRenderedGlobalSplitVarLenVideoDataset).
"""
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.data.datasets import MazeTopRenderedGlobalSplitVarLenVideoDataset


class Nav9Rooms(MazeTopRenderedGlobalSplitVarLenVideoDataset):
    n_rooms = 9

    @classmethod
    def render_trajectory(cls, outputs, inputs, predictions, end_inds,
                          n_logged_samples=3):
        """Top-down GT and predicted trajectories for logging
        (nav_9rooms.py:10-53); images [N, H, W, 3] in [0, 1]."""
        from video_gcp_torch.planning.infra.envs.layout import render_state_trajectories

        return {"image": render_state_trajectories(cls.n_rooms, inputs, predictions,
                                                   end_inds, n_logged_samples)}


config = AttrDict(
    dataset_spec=AttrDict(
        max_seq_len=100,
        dataset_class=Nav9Rooms,
        split=AttrDict(train=0.994, val=0.006, test=0.00),
        # (x, y) planar state, (dx, dy) action
        state_dim=2,
        n_actions=2,
    ),
    n_rooms=9,
    crop_window=40,
)
