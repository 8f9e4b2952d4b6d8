"""Long-horizon (500-frame, 9-level / 511-node) GCP-tree with adaptive
soft-DTW binding and attentive inference: ../gcp_tree/conf.py with the
adaptive base in place of the balanced one (reference:
experiments/prediction/base_configs/gcp_adaptive.py; README.md:135 h36m
max_seq_len 500; gcp/prediction/train.py:80-81 hierarchy_levels =
ceil(log2(max_seq_len))). 511 nodes >= 500 frames, as soft-DTW without
horizontal transitions needs. Tied layers, as in ../gcp_tree."""
from video_gcp_tpu.core.attrdict import AttrDict
from experiments.prediction.base_configs import gcp_adaptive as base_conf

configuration = AttrDict(base_conf.configuration)
configuration.update({
    'dataset_name': 'nav_25rooms_long',
    'batch_size': 16,
    'lr': 2e-4,
    'epoch_cycles_train': 4,
    'n_rooms': 25,
    'metric_pruning_scheme': 'pruned_dtw',
    # --dataset_val_sweep: same checkpoint validated at T=100 (9-room data,
    # L=7) and T=500 (this dataset, L=9)
    'dataset_sweep_specs': [
        dict(dataset_name='nav_9rooms', max_seq_len=100),
        dict(dataset_name='nav_25rooms_long', max_seq_len=500),
    ],
})

model_config = AttrDict(base_conf.model_config)
model_config.update({
    'hierarchy_levels': 9,
    'ngf': 16,
    'nz_mid_lstm': 512,
    'n_lstm_layers': 3,
    'nz_mid': 128,
    'nz_enc': 128,
    'nz_vae': 256,
    'regress_length': True,
})
model_config.pop("add_weighted_pixel_copy")
