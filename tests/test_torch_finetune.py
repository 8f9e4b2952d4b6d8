"""The port's inverse-model fine-tune (video_gcp_torch/training/
finetune_inv_mdl.py) against the JAX package's masked step on the CPU: the
JAX side is built here as scripts/finetune_inv_mdl.py builds it (the
`inv_mdl` subtree labelled, `optax.multi_transform` with the configured
RAdam for it and `set_to_zero` for the rest), on
experiments/prediction/9room/gcp_tree_widegap from the ep74 weights, one
step at B=2 with the same noise (SharedNoise). Then the fine-tune's own
loop on toy_random/gcp_tree_widegap: the checkpoint it writes differs from
its base only in the inverse model (tests/test_finetune.py's invariant).

Tolerances (tests/test_torch_train.py's ep74 ones): loss terms 1e-4
relative to max(1, |value|), grad_norm likewise; the inverse model's
parameters after the step 1e-6 absolute; every other parameter
bit-identical to its starting value."""
import jax
import numpy as np
import optax
import pytest
import torch

from test_torch_train import (
    KEY,
    LOSS_TOL_EP74,
    PARAM_TOL,
    SharedNoise,
    _compare_losses,
    _jax_batch,
    _torch_batch,
)
from video_gcp_torch.parallel.train_step import train_step
from video_gcp_torch.training import checkpoint as t_ckpt
from video_gcp_torch.training import finetune_inv_mdl as ft
from video_gcp_tpu.data.datasets import RandomVideoDataset as JRandomVideoDataset
from video_gcp_tpu.models.hyperparameters import default_hparams
from video_gcp_tpu.parallel import train_step as j_train_step
from video_gcp_tpu.training import checkpoint as j_ckpt
from video_gcp_tpu.training.config import load_config as j_load_config

CONF = "experiments/prediction/9room/gcp_tree_widegap"
WEIGHTS = "experiments/prediction/9room/gcp_tree/pretrained_ep74.npz"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread: the suite's workers share the host's cores, and
    a thread per core in each of them only waits on the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_masked_step(bundle, params, batch, noise):
    """scripts/finetune_inv_mdl.py:59-80's step, without importing it."""
    hp = default_hparams()
    mc = dict(bundle.model_config)
    mc.setdefault("batch_size", bundle.configuration["batch_size"])
    hp.override({k: v for k, v in mc.items() if k in hp})
    hp.overwrite({k: v for k, v in mc.items() if k not in hp})
    jmodel = bundle.configuration["model"](hp=dict(hp))
    labels = jax.tree_util.tree_map_with_path(
        lambda path, _: "train" if any(getattr(k, "key", None) == "inv_mdl" for k in path)
        else "freeze", params)
    conf = bundle.configuration
    tx = optax.multi_transform(
        {"train": j_train_step.make_optimizer(conf["optimizer"], conf["lr"],
                                              conf["gradient_clip"], conf["momentum"],
                                              conf["adam_beta"]),
         "freeze": optax.set_to_zero()}, labels)
    state = j_train_step.TrainState.create(params, tx)
    state, metrics = noise.run(j_train_step.make_train_step(jmodel), state,
                               _jax_batch(batch), KEY)
    return jmodel, state, jax.device_get(metrics)


def test_ep74_masked_step_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path))
    bundle = j_load_config(CONF)
    params = {"params": j_ckpt.load_pretrained_npz(WEIGHTS)["params"]}
    trainer = ft.build(CONF, WEIGHTS, "cpu", ["--feed_random_data", "1"])
    model = trainer.model
    assert model.hp["inv_mdl_params"]["temp_dist"] == 15
    dset = JRandomVideoDataset(None, dict(model.hp), bundle.data_conf, "train")
    items = [dset[i] for i in (0, 1)]
    batch = {k: np.stack([np.asarray(it[k]) for it in items]) for k in items[0]}

    noise = SharedNoise(monkeypatch)
    _, state, j_met = _jax_masked_step(bundle, params, batch, noise)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    t_met = noise.run(train_step, model, trainer.optimizer, _torch_batch(batch), 0,
                      torch.Generator())
    _compare_losses(t_met, {k: v for k, v in j_met.items()
                            if k not in ("grads_finite", "grad_norm") and np.ndim(v) == 0},
                    LOSS_TOL_EP74)
    assert bool(t_met.grads_finite) and bool(j_met["grads_finite"])
    assert abs(float(t_met.grad_norm) - float(j_met["grad_norm"])) <= \
        LOSS_TOL_EP74 * max(1.0, float(j_met["grad_norm"]))

    want = t_ckpt.flax_to_torch(jax.device_get(state.params))
    moved, worst = 0, 0.0
    for name, value in model.state_dict().items():
        if ft.is_trained(name):
            worst = max(worst, float((value - want[name].reshape(value.shape)).abs().max()))
            moved += not torch.equal(value, start[name])
        else:
            assert torch.equal(value, start[name]), name  # frozen: bit for bit
            assert torch.equal(want[name].reshape(value.shape), start[name]), name  # JAX too
    assert moved > 0 and worst < PARAM_TOL, (moved, worst)
    opt_params = {id(p) for g in trainer.optimizer.param_groups for p in g["params"]}
    assert opt_params == {id(p) for n, p in model.named_parameters()
                          if p.requires_grad and ft.is_trained(n)}


def test_finetune_loop_changes_only_the_inverse_model(monkeypatch, tmp_path):
    """The fine-tune's epoch, checkpoint and val loop on the toy config from
    a base checkpoint of the regular trainer."""
    from video_gcp_torch.training.trainer import ModelTrainer, parse_args

    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path))
    base = ModelTrainer(parse_args([
        "--path", "experiments/prediction/toy_random/gcp_tree", "--device", "cpu",
        "--resume", "none", "--num_epochs", "1", "--deterministic", "1",
        "--skip_first_val", "1"]))
    base.train_loader.dataset.n_seqs = 4
    base.run()
    base_dir = tmp_path / "prediction/toy_random/gcp_tree/weights/weights_ep0"
    trainer = ft.build("experiments/prediction/toy_random/gcp_tree_widegap", str(base_dir),
                       "cpu", ["--deterministic", "1", "--val_metric_batches", "1"])
    trainer.train_loader.dataset.n_seqs = 8  # two steps
    trainer.val_loader.dataset.n_seqs = 4
    ft.run(trainer, 1)
    got = t_ckpt.load_model_state(
        tmp_path / "prediction/toy_random/gcp_tree_widegap/weights/weights_ep0")
    start = t_ckpt.load_model_state(base_dir)
    changed = [k for k in got if ft.is_trained(k) and not torch.equal(got[k], start[k])]
    frozen = [k for k in got if not ft.is_trained(k) and not torch.equal(got[k], start[k])]
    assert changed and not frozen, (changed, frozen)
    assert trainer.step == 2
