"""The sequential VRNN of the port (video_gcp_torch/models/sequential.py)
against the JAX package's `SequentialModel`, on the CPU at a small width,
with the JAX weights carried across by `flax_to_torch`; then the trainer on
the sequential configs, on named h5 datasets and across horizons, and the
h5 benchmark agent.

Torch cannot replay JAX's random stream, and the JAX model draws inside an
`nn.scan` traced once. `StepNoise` replaces every draw on both sides with a
seeded numpy array per kind and shape, the same at every step: the
posterior's normal draws and the auxiliary models' uniform ones. The prior
is compared with injected latents, one per step, which draw nothing.

Tolerances, f32 (as tests/test_torch_train.py): rollout images and latents
1e-5 absolute; loss terms 1e-5 relative to max(1, |value|); gradients max
|port - jax| <= 1e-4 * max(1e-3, max |jax|) per parameter; parameters after
one RAdam step 1e-6 absolute.
"""
import math
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import video_gcp_torch.core.distributions as t_dist
import video_gcp_tpu.core.distributions as j_dist
from test_torch_train import (
    GRAD_TOL,
    KEY,
    LR,
    PARAM_TOL,
    _compare_grads,
    _compare_losses,
    _compare_params,
    _jax_batch,
    _jax_grad_fn,
    _seeded_params,
    _torch_batch,
)
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.data import h5
from video_gcp_torch.evaluation import eval_binding as t_eb
from video_gcp_torch.evaluation.evaluator import Evaluator
from video_gcp_torch.models.sequential import SequentialModel as TorchSeq
from video_gcp_torch.parallel.train_step import make_optimizer, train_step
from video_gcp_torch.planning.infra.agent import general_agent as t_agent
from video_gcp_torch.training.checkpoint import flax_to_torch
from video_gcp_torch.training.trainer import ModelTrainer, parse_args
from video_gcp_tpu.core.attrdict import AttrDict as JAttrDict
from video_gcp_tpu.evaluation import eval_binding as j_eb
from video_gcp_tpu.models.hyperparameters import default_hparams
from video_gcp_tpu.models.sequential import SequentialModel as JaxSeq
from video_gcp_tpu.parallel import train_step as j_train_step
from video_gcp_tpu.planning.infra.agent import general_agent as j_agent

REPO = Path(__file__).resolve().parent.parent
B, T, IMG, NZ_VAE = 2, 8, 16, 8
OUT_TOL = 1e-5  # absolute, rollout images and latents
LOSS_TOL = 1e-5  # relative to max(1, |value|)
SMALL = dict(batch_size=B, max_seq_len=T, img_sz=IMG, ngf=4, nz_mid_lstm=32,
             n_lstm_layers=2, nz_mid=32, nz_enc=32, nz_vae=NZ_VAE,
             one_step_planner="continuous", dense_rec_type="svg", hierarchy_levels=0,
             regress_length=True, attach_state_regressor=True, state_dim=2,
             attach_inv_mdl=True, inv_mdl_params=dict(n_actions=2),
             attach_cost_mdl=True, n_actions=2)
VARIANTS = {
    # 9room/gcp_sequential's heads and decoder
    "dlm": dict(decoder_distribution="discrete_logistic_mixture"),
    # the Gaussian decoder's NLL and the decoder's action regression
    "gaussian_actions": dict(decoder_distribution="gaussian", regress_actions=True,
                             action_activation="tanh", free_nats=0.05),
}


class StepNoise:
    """One seeded array per (kind, shape), returned for every draw of that
    kind and shape on both sides."""

    def __init__(self, monkeypatch, seed=0):
        rng, self.arrays, self.calls = np.random.RandomState(seed), {}, []
        noise = self

        def take(kind, shape):
            noise.calls.append(kind)
            key = (kind, tuple(shape))
            if key not in noise.arrays:
                make = rng.randn if kind == "normal" else rng.rand
                noise.arrays[key] = make(*shape).astype(np.float32)
            return noise.arrays[key]

        monkeypatch.setattr(j_dist.Gaussian, "sample", lambda g, key: g.mu + g.sigma
                            * jnp.asarray(take("normal", g.mu.shape)))
        monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), dtype=jnp.float32,
                            minval=0.0, maxval=1.0: jnp.asarray(take("uniform", shape)))
        monkeypatch.setattr(t_dist.Gaussian, "sample", lambda g, gen: g.reparametrize(
            torch.from_numpy(take("normal", g.mu.shape))))
        monkeypatch.setattr(t_dist, "uniform", lambda shape, gen, device=None:
                            torch.from_numpy(take("uniform", shape)))


def _hp(variant):
    hp = default_hparams()
    hp.overwrite(SMALL)
    hp.overwrite(VARIANTS[variant])
    return dict(hp)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    seq = (rng.rand(B, T, IMG, IMG, 3) * 2 - 1).astype(np.float32)
    end_ind = np.array([T - 1, 5], np.int32)
    pad = (np.arange(T)[None] <= end_ind[:, None]).astype(np.float32)
    return dict(traj_seq=seq, I_0=seq[:, 0], I_g=seq[np.arange(B), end_ind],
                end_ind=end_ind, pad_mask=pad,
                actions=(rng.randn(B, T - 1, 2) * 0.1).astype(np.float32),
                traj_seq_states=rng.rand(B, T, 2).astype(np.float32))


def _pair(variant, batch):
    hp = _hp(variant)
    jmodel = JaxSeq(hp=hp)
    params = _seeded_params(jmodel, _jax_batch(batch))
    tmodel = TorchSeq(hp)
    # strictly: no key left over on either side
    tmodel.load_state_dict(flax_to_torch(params), strict=True)
    return jmodel, params, tmodel


def _max_diff(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    return float(np.abs(a.astype(np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("phase", ["test", "plan"])
def test_prior_with_injected_z_matches_jax(variant, phase):
    batch = _batch()
    jmodel, params, tmodel = _pair(variant, batch)
    z = np.random.RandomState(3).randn(B, T, NZ_VAE).astype(np.float32)  # T: cut to T-1
    inputs = {k: batch[k] for k in ("I_0", "I_g", "end_ind")}
    j_out = jax.jit(lambda p, b: jmodel.apply(p, b, phase, "prior", rngs={"sample": KEY}))(
        params, _jax_batch(dict(inputs, z=z)))
    with torch.no_grad():
        t_out = tmodel(_torch_batch(dict(inputs, z=z)), phase=phase, mode="prior")
    assert t_out.dense_rec.images.shape == (B, T, IMG, IMG, 3)
    for k in ("images", "encodings"):
        assert _max_diff(t_out.dense_rec[k], j_out.dense_rec[k]) < OUT_TOL, k
    for k in ("mu", "log_sigma"):
        assert _max_diff(getattr(t_out.dense_rec.p_z, k),
                         getattr(j_out.dense_rec.p_z, k)) < OUT_TOL, k
    if phase == "plan":
        for k in ("timeline_images", "timeline_latents", "actions", "regressed_state"):
            assert _max_diff(t_out[k], j_out[k]) < OUT_TOL, k
    # the dense sample under 'basic' (the configs' metric_pruning_scheme)
    j_in = JAttrDict(traj_seq=jnp.asarray(batch["traj_seq"]),
                     end_ind=jnp.asarray(batch["end_ind"]))
    t_in = AttrDict(traj_seq=torch.from_numpy(batch["traj_seq"]),
                    end_ind=torch.from_numpy(batch["end_ind"]))
    got = t_eb.dense_sample(t_out, t_in, "basic", T)
    assert _max_diff(got, j_eb.dense_sample(j_out, j_in, "basic", T)) < OUT_TOL


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_posterior_losses_grads_and_one_radam_step_match_jax(monkeypatch, variant):
    batch = _batch()
    jmodel, params, tmodel = _pair(variant, batch)
    noise = StepNoise(monkeypatch)
    (j_total, j_losses), j_grads = _jax_grad_fn(jmodel)(params, _jax_batch(batch))
    j_calls = len(noise.calls)
    opt = make_optimizer([p for p in tmodel.parameters() if p.requires_grad],
                         "radam", LR, None, 0, 0.9)
    t_met = train_step(tmodel, opt, _torch_batch(batch), 0, torch.Generator())
    # one posterior draw per step on the port's side; the JAX scan traced it
    assert noise.calls[j_calls:].count("normal") == T - 1
    assert set(noise.calls[:j_calls]) == set(noise.calls[j_calls:]) == {"normal", "uniform"}
    expected = {"dense_img_rec", "kl", "seq_len", "action_reconst", "cost_estimation",
                "state_regression", "nll", "total"}
    if variant == "gaussian_actions":
        expected.add("dense_action_rec")
    # (T - 1 = 7 steps look like a tree's 7 nodes to the layerwise
    # breakdown of both train steps)
    assert set(t_met) - expected == {"grads_finite", "grad_norm", "kl_layerwise",
                                     "dense_img_rec_layerwise"}
    _compare_losses({k: t_met[k] for k in expected}, j_losses, LOSS_TOL)
    assert abs(float(t_met.total) - float(j_total)) <= LOSS_TOL * max(1.0, abs(float(j_total)))
    _compare_grads(tmodel, j_grads, GRAD_TOL)
    # the RAdam step of the JAX train step (make_train_step), on these grads
    tx = j_train_step.make_optimizer("radam", LR, None, 0, 0.9)
    step = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))
    assert _compare_params(tmodel, step(j_grads, params), opt, 1) < PARAM_TOL


# ---------------------------------------------------------------------------
# the trainer on h5 files
# ---------------------------------------------------------------------------


def _experiments(tmp_path, name, conf_text):
    """A conf under a copy of experiments/prediction/base_configs."""
    root = tmp_path / "experiments/prediction"
    if not (root / "base_configs").exists():
        shutil.copytree(REPO / "experiments/prediction/base_configs",
                        root / "base_configs")
    (root / name).mkdir(parents=True)
    (root / name / "conf.py").write_text(conf_text)
    return root / name


def _maze_files(d, n_files, t_file=14, seed=0, img=32):
    """Trajectories in the layout of the data generation (HDF5Saver):
    5-d states inside the 9-room maze, padded tails, stored frames."""
    rng = np.random.RandomState(seed)
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n_files):
        n_real = t_file - i % 4
        pad = (np.arange(t_file) < n_real).astype(np.float64)
        path = np.clip(np.cumsum(rng.uniform(-0.02, 0.02, (t_file, 2)), 0)
                       + rng.uniform(-0.4, 0.4, 2), -0.45, 0.45)
        states = np.concatenate([path, np.zeros((t_file, 1)), np.tile(path[-1], (t_file, 1))],
                                1) * pad[:, None]
        with h5.File(d / f"traj_{i}.h5", "w") as f:
            f.create_dataset("traj_per_file", data=1)
            f.create_dataset("traj0/images",
                             data=rng.randint(0, 256, (t_file, 1, img, img, 3), np.uint8))
            f.create_dataset("traj0/states", data=states)
            f.create_dataset("traj0/actions", data=rng.randn(t_file - 1, 2) * 0.1)
            f.create_dataset("traj0/pad_mask", data=pad)


def test_trainer_trains_the_toy_sequential_config(monkeypatch, tmp_path):
    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path))
    trainer = ModelTrainer(parse_args([
        "--path", str(REPO / "experiments/prediction/toy_random/gcp_sequential"),
        "--deterministic", "1", "--device", "cpu", "--num_epochs", "1",
        "--val_metric_batches", "1"]))
    assert type(trainer.model).__name__ == "SequentialModel"
    trainer.train_loader.dataset.n_seqs = 8  # 256 random sequences cut to 2 batches
    trainer.run()
    assert trainer.step == 2
    exp = tmp_path / "prediction/toy_random/gcp_sequential"
    assert (exp / "weights/weights_ep0").is_dir()
    # --metric's Evaluator on the sequential model: the config's 'dtw', top-of-2
    evaluator = Evaluator(trainer.model, str(tmp_path / "eval"), trainer.conf,
                          max_seq_len=16, pruning_scheme="dtw", top_of_100=False)
    evaluator._top_of = 2
    result = evaluator.eval(next(iter(trainer.val_loader)), torch.Generator().manual_seed(0))
    assert result.metrics["mse"].shape == (4, 2) and np.isfinite(result.metrics["psnr"]).all()
    assert result.best_full.shape == (4, 16, 16, 16, 3)  # the rollout, not a tree


@pytest.mark.parametrize("model", ["gcp_tree", "gcp_sequential"])
def test_trainer_trains_on_the_named_nav_9rooms_dataset(monkeypatch, tmp_path, capsys,
                                                       model):
    """nav_9rooms through its configured class (the maze re-renderer), at a
    cut horizon and width."""
    _maze_files(tmp_path / "data/nav_9rooms", 6)
    monkeypatch.setenv("GCP_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path / "exp"))
    conf = _experiments(tmp_path, f"nav/{model}", (
        "from video_gcp_tpu.core.attrdict import AttrDict\n"
        "from video_gcp_tpu.data.configs.nav_9rooms import config as nav\n"
        f"from experiments.prediction.base_configs import {model} as b\n"
        "configuration = AttrDict(b.configuration)\n"
        "configuration.update(dict(dataset_name='nav_9rooms', batch_size=2, lr=1e-3))\n"
        "data_config = AttrDict(nav)\n"
        "data_config.dataset_spec = AttrDict(nav.dataset_spec, max_seq_len=8)\n"
        "model_config = AttrDict(b.model_config)\n"
        "model_config.update(dict(img_sz=16, nz_mid_lstm=16, nz_vae=4,\n"
        "    regress_length=True, attach_state_regressor=True,\n"
        "    decoder_distribution='discrete_logistic_mixture'))\n"
        "model_config.pop('add_weighted_pixel_copy')\n"))
    trainer = ModelTrainer(parse_args(["--path", str(conf), "--device", "cpu",
                                       "--num_epochs", "1", "--val_metric_batches", "1"]))
    assert type(trainer.train_loader.dataset).__name__ == "Nav9Rooms"
    assert len(trainer.train_loader.dataset) == 5 and len(trainer.val_loader) == 1
    batch = next(iter(trainer.train_loader))
    assert batch.traj_seq.shape == (2, 8, 16, 16, 3) and batch.traj_seq.dtype == torch.uint8
    assert batch.traj_seq_states.shape == (2, 8, 2)
    trainer.run()
    out = capsys.readouterr().out
    assert trainer.step == 2 and "[val] epoch 0" in out and "| psnr" in out


def _val_recorder(trainer):
    """The val losses of each val pass of `trainer`, one dict a pass, from
    what it logs."""
    passes, real_val, real_log = [], trainer.val, trainer.logger.log_scalar

    def val(epoch):
        passes.append({})
        return real_val(epoch)

    def log_scalar(value, name, step, phase=""):
        if phase == "val" and name.endswith("_loss"):
            passes[-1][name[:-len("_loss")]] = float(value)
        return real_log(value, name, step, phase)

    trainer.val, trainer.logger.log_scalar = val, log_scalar
    return passes


def test_dataset_val_sweep_across_two_horizons(monkeypatch, tmp_path, capsys):
    """As tests/test_training.py's sweep: two datasets of horizons 16 and 8,
    val splits (4 examples) smaller than a batch (5), the length head kept
    fresh at the horizon that changes its width. The JAX trainer's sweep
    runs on the same files and the same weights (carried across by
    flax_to_torch), with `StepNoise` for every draw: each dataset's val
    losses agree within LOSS_TOL, except where the fresh head enters (the
    length loss and the total at T=8)."""
    from video_gcp_tpu.training import trainer as j_trainer

    rng = np.random.RandomState(0)
    for name, t in (("sweep_a", 16), ("sweep_b", 8)):
        d = tmp_path / "data" / name
        d.mkdir(parents=True)
        (d / "dataset_spec.py").write_text(
            f"dataset_spec = dict(max_seq_len={t}, state_dim=2, n_actions=2,"
            " split=dict(train=0.6, val=0.4, test=0.0))\n")
        for i in range(10):
            with h5.File(d / f"traj_{i}.h5", "w") as f:
                f.create_dataset("traj_per_file", data=1)
                f.create_dataset("traj0/images",
                                 data=rng.randint(0, 255, (t, 1, 16, 16, 3), np.uint8))
                f.create_dataset("traj0/states", data=rng.rand(t, 2).astype(np.float32))
                f.create_dataset("traj0/actions", data=rng.rand(t - 1, 2).astype(np.float32))
                f.create_dataset("traj0/pad_mask", data=np.ones(t))
    monkeypatch.setenv("GCP_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path / "exp"))
    conf = _experiments(tmp_path, "sweep/gcp_tree", (
        "from video_gcp_tpu.core.attrdict import AttrDict\n"
        "from experiments.prediction.base_configs import gcp_tree as b\n"
        "configuration = AttrDict(b.configuration)\n"
        "configuration.update(dict(\n"
        "    dataset_name='sweep_a', batch_size=5, lr=1e-3,\n"
        "    dataset_sweep_specs=[\n"
        "        dict(dataset_name='sweep_a', max_seq_len=16),\n"
        "        dict(dataset_name='sweep_b', max_seq_len=8),\n"
        "    ],\n"
        "))\n"
        "model_config = AttrDict(b.model_config)\n"
        "model_config.update(dict(hierarchy_levels=4, img_sz=16, ngf=8,\n"
        "    nz_mid_lstm=48, nz_vae=8, regress_length=True))\n"
        "model_config.pop('add_weighted_pixel_copy')\n"))
    StepNoise(monkeypatch)
    common = ["--path", str(conf), "--resume", "none", "--dataset_val_sweep", "1",
              "--val_metric_batches", "0"]
    jax_trainer = j_trainer.ModelTrainer(j_trainer.parse_args(common + ["--prefix", "jax"]))
    trainer = ModelTrainer(parse_args(common + ["--device", "cpu"]))
    trainer.model.load_state_dict(flax_to_torch(jax.device_get(jax_trainer.state.params)),
                                  strict=True)
    jax_passes, passes = _val_recorder(jax_trainer), _val_recorder(trainer)
    jax_trainer.run()
    capsys.readouterr()
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.run()
    out = capsys.readouterr().out
    assert f"[dataset sweep] sweep_a (T=16, L={math.ceil(math.log2(16))})" in out
    assert "[dataset sweep] sweep_b (T=8, L=3)" in out
    assert out.count("[val] epoch 0") == 2 and out.count("nll") >= 2, out
    assert out.count("kept fresh") == 1 and "length_pred" in out
    assert trainer.model.hp["max_seq_len"] == 16  # the trainer's own model is back
    assert all(torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())
    assert len(passes) == len(jax_passes) == 2
    for got, want, fresh in zip(passes, jax_passes, (set(), {"seq_len", "total"})):
        assert set(got) == set(want) and {"nll", "kl", "dense_img_rec"} <= set(got)
        for k in set(got) - fresh:
            assert abs(got[k] - want[k]) <= LOSS_TOL * max(1.0, abs(want[k])), (k, got, want)


def test_dataset_val_sweep_on_the_25room_long_specs(monkeypatch, tmp_path, capsys):
    """25room_long/gcp_tree's own sweep specs (nav_9rooms at T=100, L=7,
    through its re-renderer; nav_25rooms_long at T=500, L=9, stored 64x64
    frames) on synthesized files, its config cut to a narrow width."""
    _maze_files(tmp_path / "data/nav_9rooms", 2, t_file=101)
    rng = np.random.RandomState(1)
    d = tmp_path / "data/nav_25rooms_long"
    d.mkdir(parents=True)
    for i in range(2):
        with h5.File(d / f"traj_{i}.h5", "w") as f:
            f.create_dataset("traj_per_file", data=1)
            f.create_dataset("traj0/images",
                             data=rng.randint(0, 256, (501, 1, 64, 64, 3), np.uint8))
            f.create_dataset("traj0/states", data=rng.rand(501, 2))
            f.create_dataset("traj0/actions", data=rng.randn(500, 2) * 0.1)
            f.create_dataset("traj0/pad_mask", data=np.ones(501))
    monkeypatch.setenv("GCP_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path / "exp"))
    conf = _experiments(tmp_path, "25room_long/gcp_tree", (
        (REPO / "experiments/prediction/25room_long/gcp_tree/conf.py").read_text()
        + "configuration.update(dict(batch_size=2))\n"
        "model_config.update(dict(img_sz=16, ngf=2, nz_mid_lstm=16, n_lstm_layers=2,\n"
        "    nz_mid=16, nz_enc=16, nz_vae=4))\n"))
    trainer = ModelTrainer(parse_args(["--path", str(conf), "--resume", "none",
                                       "--device", "cpu", "--dataset_val_sweep", "1",
                                       "--val_metric_batches", "0"]))
    passes = _val_recorder(trainer)
    trainer.run()
    out = capsys.readouterr().out
    assert "[dataset sweep] nav_9rooms (T=100, L=7)" in out
    assert "[dataset sweep] nav_25rooms_long (T=500, L=9)" in out
    assert out.count("kept fresh") == 1 and "length_pred" in out
    assert len(passes) == 2
    assert all(np.isfinite(v) for p in passes for v in p.values()) and "nll" in passes[1]


def test_benchmark_agent_loads_an_h5_trajectory_like_jax(tmp_path):
    """Start state, goal and the goal image (bilinear to the agent's size)
    from a file the port's saver layout writes, against the JAX agent
    (h5py and cv2). Tolerance: the goal image within 1e-5 (resize_linear,
    tests/test_torch_datasets.py); the states exactly."""
    _maze_files(tmp_path / "data", 3, t_file=12, img=128)
    for itr in (0, 4):
        agents = []
        for mod in (j_agent, t_agent):
            agent = object.__new__(mod.BenchmarkAgentLoadHDF5)
            agent._start_goal_confs = str(tmp_path / "data")
            agent._hp = AttrDict(image_height=32, image_width=32)
            agents.append((agent, agent._load_raw_data(itr)))
        (j, j_reset), (t, t_reset) = agents
        np.testing.assert_array_equal(t_reset, j_reset)
        np.testing.assert_array_equal(t._goal, j._goal)
        assert t._goal_image.shape == j._goal_image.shape == (1, 1, 32, 32, 3)
        assert np.abs(t._goal_image - j._goal_image).max() <= 1e-5
