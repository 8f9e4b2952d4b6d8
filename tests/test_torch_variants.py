"""The model variants of the paper's planning baselines, port against the
JAX package on the CPU, on the same weights carried by `flax_to_torch`
(strict=True, every 3x3 kernel drawn from a seed and so not symmetric in
space): the ConvLSTM stack alone, in a tree and in the VRNN; action
conditioning (VMPC: `action_conditioned_pred`, `non_goal_conditioned`,
nz_vae=0) and `act_cond_inference`; goal-conditioned behavioral cloning,
reactive and recurrent, and its training through the trainer.

Mirrors tests/test_variants.py:63-160 at B=2, T <= 10, 16x16 images. The
modes draw no random numbers, or draw them through `SharedNoise` /
`StepNoise` (the same seeded arrays on both sides): the prior with injected
z, VMPC's zero-width latent, the BC model.

Tolerances, f32: outputs (images, latents, packed states, actions) 1e-5
absolute; loss terms 1e-5 relative to max(1, |value|); gradients max
|port - jax| <= 1e-4 * max(1e-3, max |jax|) per parameter
(tests/test_torch_train.py's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sequential import StepNoise
from test_torch_train import (
    GRAD_TOL,
    KEY,
    LOSS_TOL,
    SharedNoise,
    _compare_grads,
    _compare_losses,
    _jax_batch,
    _jax_grad_fn,
    _seeded_params,
    _torch_batch,
)
from video_gcp_torch.models import nets as t_nets
from video_gcp_torch.models.bc import BCModel as TorchBC
from video_gcp_torch.models.sequential import SequentialModel as TorchSeq
from video_gcp_torch.models.tree import TreeModel as TorchTree
from video_gcp_torch.parallel.train_step import make_optimizer, train_step
from video_gcp_torch.training.checkpoint import flax_to_torch
from video_gcp_torch.training.trainer import ModelTrainer, parse_args
from video_gcp_tpu.models import nets as j_nets
from video_gcp_tpu.models.bc import BCModel as JaxBC
from video_gcp_tpu.models.hyperparameters import default_hparams
from video_gcp_tpu.models.sequential import SequentialModel as JaxSeq
from video_gcp_tpu.models.tree import TreeModel as JaxTree

B, T, IMG = 2, 8, 16
OUT_TOL = 1e-5  # absolute


def _hp(**over):
    hp = default_hparams()
    hp.overwrite(dict(batch_size=B, max_seq_len=T, img_sz=IMG))
    hp.overwrite(over)
    return dict(hp)


def _batch(seed=0):
    """tests/test_variants.py's inputs, with a short second sequence."""
    rng = np.random.RandomState(seed)
    seq = (rng.rand(B, T, IMG, IMG, 3) * 2 - 1).astype(np.float32)
    end_ind = np.array([T - 1, T - 3], np.int32)
    pad = (np.arange(T)[None] <= end_ind[:, None]).astype(np.float32)
    return dict(traj_seq=seq, I_0=seq[:, 0], I_g=seq[np.arange(B), end_ind],
                end_ind=end_ind, pad_mask=pad,
                actions=(rng.randn(B, T - 1, 2) * 0.3).astype(np.float32),
                traj_seq_states=rng.rand(B, T, 2).astype(np.float32))


def _asymmetric_3x3(params):
    """Every 3x3 kernel of the tree differs from its spatial transpose, so
    that a bridge which swapped H and W would show."""
    n = 0
    for path, a in jax.tree_util.tree_flatten_with_path(params)[0]:
        if path[-1].key == "kernel" and a.ndim == 4 and a.shape[:2] == (3, 3):
            assert not np.allclose(a, np.swapaxes(a, 0, 1)), path
            n += 1
    return n


def _pair(jcls, tcls, hp, batch):
    jmodel = jcls(hp=hp)
    params = _seeded_params(jmodel, _jax_batch(batch))
    tmodel = tcls(hp)
    tmodel.load_state_dict(flax_to_torch(params), strict=True)
    return jmodel, params, tmodel


def _max_diff(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    return float(np.abs(a.astype(np.float64) - np.asarray(b, np.float64)).max())


def _prior(jmodel, params, tmodel, inputs, phase="test"):
    j_out = jax.jit(lambda p, b: jmodel.apply(p, b, phase, "prior", rngs={"sample": KEY}))(
        params, _jax_batch(inputs))
    with torch.no_grad():
        t_out = tmodel(_torch_batch(inputs), phase=phase, mode="prior",
                       generator=torch.Generator().manual_seed(0))
    return j_out, t_out


def _train_step_matches(monkeypatch, jmodel, params, tmodel, batch, noise_cls,
                        grad_tols=None):
    """Losses and gradients of one train step, port against JAX; `grad_tols`
    names the parameters held to a tolerance of their own."""
    noise = noise_cls(monkeypatch)
    grad_fn = _jax_grad_fn(jmodel)
    opt = make_optimizer([p for p in tmodel.parameters() if p.requires_grad], "radam", 1e-3)
    if noise_cls is SharedNoise:
        (_, j_losses), j_grads = noise.run(grad_fn, params, _jax_batch(batch))
        t_met = noise.run(train_step, tmodel, opt, _torch_batch(batch), 0, torch.Generator())
    else:
        (_, j_losses), j_grads = grad_fn(params, _jax_batch(batch))
        t_met = train_step(tmodel, opt, _torch_batch(batch), 0, torch.Generator())
    _compare_losses(t_met, j_losses, LOSS_TOL)
    if not grad_tols:
        _compare_grads(tmodel, j_grads, GRAD_TOL)
        return t_met, j_losses
    want = flax_to_torch(jax.device_get(j_grads))
    for name, p in tmodel.named_parameters():
        if p.requires_grad:  # (LSTM bias_ih: zeros, not a flax parameter)
            w = want[name].numpy()
            rel = np.abs(p.grad.numpy() - w).max() / max(1e-3, np.abs(w).max())
            assert rel < grad_tols.get(name, GRAD_TOL), (name, rel)
    return t_met, j_losses


# ---------------------------------------------------------------------------
# ConvLSTMStack and the bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_layers, lead", [(1, (3,)), (2, (2, 3))])
def test_conv_lstm_stack_matches_flax(n_layers, lead):
    """State packed [layer, (c|h), y, x, channel], flax's gate order i, g, f, o
    and its forget bias, the Dense stem onto the 4x4 grid, the mean-pooled
    top h."""
    size, in_size = 6, 10
    rng = np.random.RandomState(0)
    stack = j_nets.ConvLSTMStack(size, n_layers)
    state = rng.randn(*lead, stack.state_size).astype(np.float32)
    x = rng.randn(*lead, in_size).astype(np.float32)
    shapes = jax.eval_shape(lambda: stack.init(KEY, jnp.asarray(state), jnp.asarray(x)))
    params = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) / np.sqrt(max(1, np.prod(s.shape[:-1])))).astype(
            np.float32), shapes)
    assert _asymmetric_3x3(params) == 2 * n_layers
    s_j, o_j = stack.apply(params, jnp.asarray(state), jnp.asarray(x))
    port = t_nets.ConvLSTMStack(in_size, size, n_layers)
    assert port.state_size == stack.state_size == n_layers * 2 * 16 * size
    port.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        s_t, o_t = port(torch.from_numpy(state), torch.from_numpy(x))
        top = port.top_h(s_t)
    assert s_t.shape == lead + (stack.state_size,) and o_t.shape == lead + (size,)
    assert _max_diff(s_t, s_j) < OUT_TOL
    assert _max_diff(o_t, o_j) < OUT_TOL
    assert _max_diff(top, stack.top_h(s_j)) < OUT_TOL
    assert _max_diff(top, o_t) < OUT_TOL  # the step output is the new top h, pooled


def test_bridge_lays_out_named_conv_kernels_by_rank():
    """ConvLSTMCell's `ih`/`hh` and the tree's `proj_i` are convs whose kind
    the module name does not tell: their kernels go [out, in, kh, kw], not
    transposed as a Dense kernel; a Dense kernel of the same names stays
    [out, in]."""
    k = np.arange(3 * 3 * 2 * 5, dtype=np.float32).reshape(3, 3, 2, 5)
    d = np.arange(6, dtype=np.float32).reshape(2, 3)
    tree = {"ConvLSTMCell_0": {"ih": {"kernel": k, "bias": np.zeros(5, np.float32)}},
            "proj_1": {"kernel": k}, "proj_2": {"kernel": d}}
    out = flax_to_torch(tree)
    want = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    assert torch.equal(out["conv_lstm_cell.0.ih.weight"], want)
    assert torch.equal(out["proj.1.weight"], want)
    assert not torch.equal(want, torch.from_numpy(k.T.copy()))  # H and W swapped
    assert torch.equal(out["proj.2.weight"], torch.from_numpy(d.T.copy()))


# ---------------------------------------------------------------------------
# ConvLSTM in a tree and in the VRNN
# ---------------------------------------------------------------------------

TREE = dict(hierarchy_levels=3, matching_type="balanced", nz_vae=8, nz_mid_lstm=6)


@pytest.mark.parametrize("fusion, init, layers", [("split_linear", "mlp", 2),
                                                  ("linear", "zero", 1), ("sum", "mlp", 1)])
def test_conv_lstm_tree_prior_matches_jax(fusion, init, layers):
    hp = _hp(**TREE, tree_lstm=fusion, lstm_init=init, n_lstm_layers=layers,
             use_conv_lstm=True)
    batch = _batch()
    jmodel, params, tmodel = _pair(JaxTree, TorchTree, hp, batch)
    assert _asymmetric_3x3(params) > 0
    z = np.random.RandomState(3).randn(B, 7, 8).astype(np.float32)
    inputs = dict({k: batch[k] for k in ("I_0", "I_g", "end_ind")}, z=z)
    j_out, t_out = _prior(jmodel, params, tmodel, inputs)
    for k in ("images", "e_g_prime"):
        assert _max_diff(t_out.tree[k], j_out.tree[k]) < OUT_TOL, k


def test_conv_lstm_tree_train_step_matches_jax(monkeypatch):
    """tests/test_variants.py:test_conv_lstm_tree's model (split_linear,
    mlp init), one train step's losses and gradients."""
    hp = _hp(**TREE, tree_lstm="split_linear", lstm_init="mlp", use_conv_lstm=True)
    batch = _batch()
    jmodel, params, tmodel = _pair(JaxTree, TorchTree, hp, batch)
    names = {n for n, _ in tmodel.named_parameters()}
    assert "tree_levels.0.subgoal_pred.proj.1.weight" in names
    assert "tree_levels.0.subgoal_pred.conv_lstm_stack.0.conv_lstm_cell.0.hh.bias" in names
    _train_step_matches(monkeypatch, jmodel, params, tmodel, batch, SharedNoise)


SEQ_CONV = dict(hierarchy_levels=0, n_actions=2, nz_vae=8, nz_mid_lstm=6, n_lstm_layers=2,
                use_conv_lstm=True, regress_actions=True, one_step_planner="continuous",
                action_activation="tanh")


def test_conv_lstm_sequential_matches_jax(monkeypatch):
    """tests/test_variants.py:test_conv_lstm_sequential_with_action_regression's
    model: the prior with injected z, then one train step."""
    hp = _hp(**SEQ_CONV)
    batch = _batch()
    jmodel, params, tmodel = _pair(JaxSeq, TorchSeq, hp, batch)
    assert _asymmetric_3x3(params) == 2 * 2 + 1  # two cells' ih and hh, the decoder's
    z = np.random.RandomState(3).randn(B, T, 8).astype(np.float32)
    inputs = dict({k: batch[k] for k in ("I_0", "I_g", "end_ind")}, z=z)
    j_out, t_out = _prior(jmodel, params, tmodel, inputs)
    for k in ("images", "encodings"):
        assert _max_diff(t_out.dense_rec[k], j_out.dense_rec[k]) < OUT_TOL, k
    assert _max_diff(t_out.dense_rec.p_z.mu, j_out.dense_rec.p_z.mu) < OUT_TOL
    t_met, _ = _train_step_matches(monkeypatch, jmodel, params, tmodel, batch, StepNoise)
    assert "dense_action_rec" in t_met


# ---------------------------------------------------------------------------
# action conditioning
# ---------------------------------------------------------------------------

# base_configs/vmpc.py over the sequential model, at 9room/gcp_sequential's
# ngf 16. non_goal_conditioned zeroes the goal image, so the first conv's
# output is its bias alone, constant over the frame: the first GroupNorm's
# variance is then the spread of a group's biases, from E[x^2] - E[x]^2 in
# both packages (flax's and the twin's), and their rounding differences
# come out amplified by 1/std. With ngf 16 (two channels a group) the
# rollout differs by up to 1.9e-5, with ngf 4 (one, variance ~0) by 5.4e-4;
# without the zeroed goal by 1.4e-6. Hence 1e-4 for VMPC's outputs. The
# gradient of that conv's bias, which reaches it only through this norm,
# differs by 2.9e-3 of its largest value (1.7e-5 without the zeroed goal;
# every other gradient within GRAD_TOL): 1e-2 for it.
VMPC = dict(hierarchy_levels=0, action_conditioned_pred=True, non_goal_conditioned=True,
            nz_vae=0, var_inf="deterministic", n_actions=2, ngf=16, regress_length=True)
VMPC_OUT_TOL = 1e-4
VMPC_GRAD_TOL = 1e-2  # encoder.conv.0.bias


def test_vmpc_matches_jax_with_zero_kl(monkeypatch):
    hp = _hp(**VMPC)
    batch = _batch()
    jmodel, params, tmodel = _pair(JaxSeq, TorchSeq, hp, batch)
    assert "action_encoder" in params["params"]
    # the rollout driven by the actions alone: no z, a fixed length
    inputs = {k: batch[k] for k in ("I_0", "I_g", "end_ind", "actions")}
    for phase in ("test", "plan"):
        j_out, t_out = _prior(jmodel, params, tmodel, inputs, phase)
        for k in ("images", "encodings"):
            assert _max_diff(t_out.dense_rec[k], j_out.dense_rec[k]) < VMPC_OUT_TOL, (phase, k)
    with torch.no_grad():
        t_plan = tmodel(_torch_batch(inputs), phase="plan", mode="prior", pred_length=True,
                        generator=torch.Generator().manual_seed(0))
    assert (t_plan.end_ind == T - 1).all()  # action-conditioned: max_seq_len - 1
    # other actions, another rollout
    moved = dict(inputs, actions=inputs["actions"][::-1].copy())
    with torch.no_grad():
        t_moved = tmodel(_torch_batch(moved), phase="test", mode="prior",
                         generator=torch.Generator().manual_seed(0))
    assert _max_diff(t_moved.dense_rec.encodings[0], t_out.dense_rec.encodings[0]) > 1e-3
    # the goal's first conv bias: see VMPC above (measured 2.9e-3)
    t_met, j_losses = _train_step_matches(monkeypatch, jmodel, params, tmodel, batch,
                                          StepNoise, {"encoder.conv.0.bias": VMPC_GRAD_TOL})
    assert float(t_met.kl) == float(j_losses.kl.value) == 0.0  # q == p == empty


def test_vmpc_needs_actions():
    tmodel = TorchSeq(_hp(**VMPC))
    batch = _batch()
    with pytest.raises(ValueError, match="actions"):
        tmodel(_torch_batch({k: batch[k] for k in ("I_0", "I_g", "end_ind")}))


def test_act_cond_inference_tree_matches_jax(monkeypatch):
    """tests/test_variants.py:test_act_cond_inference_tree's model: the
    zero-padded actions fused into the inference encoding."""
    hp = _hp(hierarchy_levels=3, matching_type="balanced", seq_enc="conv",
             act_cond_inference=True, n_actions=2, nz_vae=8)
    batch = _batch()
    jmodel, params, tmodel = _pair(JaxTree, TorchTree, hp, batch)
    assert "act_cond_net" in params["params"]
    _train_step_matches(monkeypatch, jmodel, params, tmodel, batch, SharedNoise)


def test_use_convs_false_still_raises():
    with pytest.raises(NotImplementedError, match="use_convs"):
        TorchSeq(_hp(hierarchy_levels=0, use_convs=False))


# ---------------------------------------------------------------------------
# behavioral cloning
# ---------------------------------------------------------------------------

BC = dict(n_actions=2, nz_mid_lstm=16, n_lstm_layers=2)


@pytest.mark.parametrize("reactive", [True, False])
def test_bc_matches_jax(monkeypatch, reactive):
    """The loss (pad_mask[:, :n], the total at weight 0), its gradients, and
    act_single with the hidden state threaded over three steps."""
    hp = _hp(**BC, reactive=reactive)
    batch = _batch()
    jmodel, params, tmodel = _pair(JaxBC, TorchBC, hp, batch)
    assert ("lstm" in params["params"]) != reactive
    j_out = jax.jit(lambda p, b: jmodel.apply(p, b, "train", "posterior"))(
        params, _jax_batch(batch))
    with torch.no_grad():
        t_out = tmodel(_torch_batch(batch))
    assert t_out.actions.shape == (B, T - 1, 2)
    assert _max_diff(t_out.actions, j_out.actions) < OUT_TOL
    assert t_out.losses.total.weight == 0.0

    act = jax.jit(lambda p, a, b, h: jmodel.apply(p, a, b, h, method=JaxBC.act_single))
    j_hidden = t_hidden = None
    seq = batch["traj_seq"]
    for t in range(3):
        j_a, j_hidden = act(params, jnp.asarray(seq[:, t]), jnp.asarray(batch["I_g"]), j_hidden)
        with torch.no_grad():
            t_a, t_hidden = tmodel.act_single(torch.from_numpy(seq[:, t]),
                                              torch.from_numpy(batch["I_g"]), t_hidden)
        assert t_a.shape == (B, 2) and _max_diff(t_a, j_a) < OUT_TOL
        assert (t_hidden is None) == reactive
        if not reactive:
            assert _max_diff(t_hidden, j_hidden) < OUT_TOL
    _train_step_matches(monkeypatch, jmodel, params, tmodel, batch, StepNoise)


def test_bc_trains_through_the_trainer(monkeypatch, tmp_path):
    """A config whose model is the JAX package's BCModel trains the port's
    through ModelTrainer (the import hook maps video_gcp_tpu.models.bc)."""
    root = tmp_path / "experiments/prediction/bc"
    root.mkdir(parents=True)
    (root / "conf.py").write_text(
        "from video_gcp_tpu.models.bc import BCModel\n"
        "configuration = {'model': BCModel, 'batch_size': 4, 'epoch_cycles_train': 1}\n"
        "model_config = {'n_actions': 2, 'img_sz': 16, 'max_seq_len': 10, 'reactive': False,\n"
        "                'nz_mid_lstm': 16}\n")
    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path / "exp"))
    trainer = ModelTrainer(parse_args([
        "--path", str(root), "--feed_random_data", "1", "--deterministic", "1",
        "--device", "cpu", "--num_epochs", "1"]))
    assert isinstance(trainer.model, TorchBC) and not trainer.model.reactive
    trainer.train_loader.dataset.n_seqs = 8  # 2 steps
    trainer.val_loader.dataset.n_seqs = 4
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    trainer.run()
    assert trainer.step == 2
    assert (tmp_path / "exp/prediction/bc/weights/weights_ep0/state.pt").is_file()
    # (the total is divided by T*H*W*C: the smallest updates round away in
    # float32, and a conv bias before a one-channel norm group has none)
    moved = {n for n, p in trainer.model.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    assert {"head.weight", "lstm.optimized_lstm_cell.0.weight_ih"} <= moved
    assert len(moved) > len(before) // 2
