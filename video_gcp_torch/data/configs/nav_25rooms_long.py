"""nav_25rooms_long dataset config: a 500-frame horizon in the 25-room maze
(the reference's h36m horizon, README.md:135). Its frames are stored
rendered (64x64) by the data generation, so the plain variable-length
reader applies: no re-rendering in training."""
from video_gcp_torch.core.attrdict import AttrDict

config = AttrDict(
    dataset_spec=AttrDict(
        max_seq_len=500,
        split=AttrDict(train=0.97, val=0.03, test=0.00),
        state_dim=2,
        n_actions=2,
    ),
    n_rooms=25,
    crop_window=40,
)
