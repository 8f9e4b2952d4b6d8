"""Fine-tune only the inverse model of a trained GCP model
(scripts/finetune_inv_mdl.py of the JAX package).

The inverse model trains on stop-gradient encodings of frame pairs
(models/base.py:run_aux_models), so its head can be retrained, for example
on wide-gap pairs (`inv_mdl_params.temp_dist` > 1, as
experiments/prediction/9room/gcp_tree_widegap sets), without touching the
predictor. The control configs `control/9room/gcp_tree_widegap` and
`gcp_tree_wgcursor` read the result as their policy checkpoint.

    python -m video_gcp_torch.training.finetune_inv_mdl --path <conf_dir> \\
        --base <weights_epN dir | pretrained .npz> --epochs N [--device cpu] \\
        [trainer options, e.g. --feed_random_data 1 --val_metric_batches 1]

Runs on the card unless `--device cpu` is given, in one process. The model
starts from `--base`; RAdam (the configuration's optimizer, learning rate
and clip) steps the parameters under `inv_mdl` and nothing else, then every
epoch is checkpointed under the config's experiment directory and
validated, as in the JAX script.

How it matches the JAX step, which labels the `inv_mdl` subtree and runs
`optax.multi_transform` with `set_to_zero` for the rest: every parameter
keeps its gradient, so the backward runs through the whole model as in a
regular step (20 K1 and 20 K2 launches a step on 9room/gcp_tree) and the
finite mask and `grad_norm` cover every gradient; the optimizer holds only
the inverse model's parameters, so the clip sees only their gradients and
the frozen parameters, which have no moments, do not move at all. Freezing
the trunk with requires_grad=False would skip its backward (no K2) but
drop its gradients from the finite mask, which the JAX step checks.
"""
from __future__ import annotations

import argparse

from video_gcp_torch.parallel.train_step import make_optimizer
from video_gcp_torch.training import checkpoint as ckpt
from video_gcp_torch.training.trainer import ModelTrainer, parse_args

TRAINED = "inv_mdl"


def is_trained(name: str) -> bool:
    """Whether a parameter name lies in the inverse model's subtree (the
    JAX script's label, a path component named `inv_mdl`)."""
    return TRAINED in name.split(".")


def build(path: str, base: str, device: str = "cuda", trainer_args=()) -> ModelTrainer:
    """A ModelTrainer of `path` from the weights `base`, its optimizer over
    the inverse model's parameters alone."""
    trainer = ModelTrainer(parse_args(["--path", path, "--resume", "none",
                                       "--device", device, *trainer_args]))
    if trainer.mesh is not None:
        raise ValueError("the inverse-model fine-tune runs in one process")
    model = trainer.model
    ckpt.load_model_weights(model, ckpt.load_model_state(base))
    trained = [p for n, p in model.named_parameters() if p.requires_grad and is_trained(n)]
    if not trained:
        raise ValueError(f"{path}: the model has no {TRAINED} parameters")
    conf = trainer.conf
    trainer.optimizer = make_optimizer(trained, conf["optimizer"], conf["lr"] or 1e-3,
                                       conf["gradient_clip"], conf["momentum"],
                                       conf["adam_beta"])
    trainer.print(f"fine-tuning {sum(p.numel() for p in trained)} {TRAINED} parameters "
                  f"(temp_dist={trainer.hp['inv_mdl_params'].get('temp_dist', 1)}); all "
                  "other parameters frozen")
    return trainer


def run(trainer: ModelTrainer, epochs: int) -> None:
    """The JAX script's loop: each epoch trained, checkpointed, validated."""
    try:
        for epoch in range(epochs):
            trainer.train_epoch(epoch)
            ckpt.save_checkpoint(trainer.exp_path, epoch, trainer.model, trainer.optimizer,
                                 trainer.step, write=trainer.is_main)
            trainer.val(epoch)
    finally:
        trainer.logger.close()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--path", required=True,
                   help="conf dir whose model_config sets the new inv_mdl_params")
    p.add_argument("--base", required=True,
                   help="the weights to start from: a weights_epN directory or a "
                        "pretrained .npz of the JAX package")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args, trainer_args = p.parse_known_args(argv)
    run(build(args.path, args.base, args.device, trainer_args), args.epochs)


if __name__ == "__main__":
    main()
