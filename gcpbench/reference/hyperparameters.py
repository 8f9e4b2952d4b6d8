"""Default hyperparameter registry for all GCP models.

Mirrors the full hparam surface of the reference —
gcp/prediction/hyperparameters.py:4-150 plus the BaseModel data/network params
(gcp/prediction/models/auxilliary_models/base_model.py:34-70) — so every
published experiment config overrides against the same names with the same
"must differ from default" hygiene rule (ParamDict.override).

A copy of video_gcp_tpu.models.hyperparameters, kept here because the port
imports nothing of the JAX package. Deviations from the reference defaults
are documented inline.
"""
from __future__ import annotations

from .params import ParamDict


def default_hparams() -> ParamDict:
    p = ParamDict()

    # --- data dimensions (base_model.py:36-44) ---
    p.update(dict(
        batch_size=-1,
        max_seq_len=-1,
        n_actions=-1,
        state_dim=-1,
        img_sz=32,
        input_nc=3,
        n_conv_layers=None,
    ))

    # --- network params (base_model.py:47-52) ---
    p.update(dict(
        use_convs=True,
        # the reference defaults to batch norm; we default to group norm:
        # batch statistics break jit purity/sharding and group norm is the
        # standard TPU-friendly choice with identical model capability
        normalization='group',
    ))

    # --- dataset plumbing (base_model.py:55-64) ---
    p.update(dict(
        dataset_class=None,
        split=None,
        standardize=None,
        checkpt_path=None,
        randomize_length=False,
        randomize_start=False,
    ))

    # --- network size (hyperparameters.py:13-30) ---
    p.update(dict(
        ngf=4,
        nz_enc=32,
        nz_vae=32,
        nz_vae2=256,
        nz_mid=32,
        nz_mid_lstm=32,
        n_lstm_layers=1,
        n_processing_layers=3,
        conv_inf_enc_kernel_size=3,
        conv_inf_enc_layers=1,
        n_attention_heads=1,
        n_attention_layers=1,
        nz_attn_key=32,
        init_mlp_layers=3,
        init_mlp_mid_sz=32,
    ))

    # --- network behavior (hyperparameters.py:33-37) ---
    p.update(dict(
        action_activation=None,
        device=None,
        context_every_step=True,
    ))

    # --- loss weights (hyperparameters.py:40-48) ---
    p.update(dict(
        kl_weight=1.0,
        kl_weight_burn_in=None,
        entropy_weight=0.0,
        length_pred_weight=1.0,
        dense_img_rec_weight=1.0,
        dense_action_rec_weight=1.0,
        free_nats=0,
    ))

    # --- architecture (hyperparameters.py:51-70) ---
    p.update(dict(
        use_skips=True,
        skips_stride=2,
        add_weighted_pixel_copy=False,
        pixel_shift_decoder=False,
        skip_from_parents=False,
        seq_enc='none',  # ['none', 'conv', 'lstm', 'bi-lstm']
        regress_actions=False,
        learn_attn_temp=True,
        attention_temperature=1.0,
        attach_inv_mdl=False,
        attach_cost_mdl=False,
        run_cost_mdl=True,
        attach_state_regressor=False,
        action_conditioned_pred=False,
        learn_beta=True,
        initial_sigma=1.0,
        separate_cnn_start_goal_encoder=False,
        decoder_distribution='gaussian',  # [gaussian, discrete_logistic_mixture]
    ))

    # --- RNN (hyperparameters.py:73-75) ---
    p.update(dict(
        use_conv_lstm=False,
    ))

    # --- variational inference (hyperparameters.py:78-81) ---
    p.update(dict(
        prior_type='learned',  # ['fixed', 'learned']
        var_inf='standard',  # ['standard', '2layer', 'deterministic']
    ))

    # --- tree / matching (hyperparameters.py:84-120) ---
    p.update(dict(
        hierarchy_levels=3,
        one_hot_attn_time_cond=False,
        attentive_inference=False,
        non_goal_conditioned=False,
        tree_lstm='',  # ['', 'sum', 'linear', 'split_linear']
        lstm_init='zero',  # ['zero', 'mlp']
        matching_temp=1.0,
        matching_temp_tenthlife=-1,
        matching_temp_min=1e-3,
        matching_type='latent',  # ['dtw_image', 'dtw_latent', 'balanced', ...]
        leaves_bias=0.0,
        top_bias=1.0,
        n_top_bias_nodes=1,
        supervise_match_weight=0.0,
        regress_index=False,
        regress_length=False,
        inv_mdl_params={},
        train_inv_mdl_full_seq=False,
        cost_mdl_params={},
        act_cond_inference=False,
        train_on_action_seqs=False,
        learned_pruning_threshold=0.5,
        untied_layers=False,
        supervised_decoder=False,
        states_inference=False,
    ))

    # --- legacy switches kept for config parity (hyperparameters.py:123-128) ---
    p.update(dict(
        dense_rec_type='none',
        one_step_planner='discrete',
        mask_inf_attention=False,
        binding='frames',
    ))

    # --- matching (hyperparameters.py:131-133) ---
    p.update(dict(
        learn_matching_temp=True,
    ))

    # --- logging (hyperparameters.py:136-147) ---
    p.update(dict(
        dump_encodings='',
        dump_encodings_inv_model='',
        log_states_2d=False,
        log_cartgripper=False,
        data_dir='',
        log_d2b_3x3maze=0,
    ))

    return p
