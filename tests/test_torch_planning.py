"""The port's CEM planning stack against the JAX package's, on the CPU, in
f32 with the same weights.

- `GCPImageSimulator`: the same start, goal and injected latents through
  both simulators, at tests/test_planning.py's small size (L=4, 16x16) and
  with the 9-room ep74 model at 2 candidates. z is injected, so the
  predicted length is the one random draw left: both models get
  `length_pred_weight=0`, which makes the 'plan' call keep the given
  end_ind (base.py:get_end_ind) while it still computes the length logits,
  compared on their own. Tolerances are tests/test_torch_tree.py's
  (chip_smoke.py's TOLS_SLICE): images 2e-4, latents 5e-4, actions and
  states 1e-4, length logits 1e-4.
- `LearnedCostEstimate` on ep74's `cost_mdl` (1e-5 relative), on single
  pairs and on the summed sequences the optimizer scores.
- `localize_on_plan` (the same indices), `_infer_action` on ep74 (1e-4),
  the planner hparams the port builds from the 9-room control config
  (equal to the JAX package's apart from class values), and localized
  tracking that reads its window at every call.
- The tree optimizer, the sampler and the hierarchical planner around a
  numpy stub simulator: identical numbers under the same np.random seed.
- One whole `ImageCEMPolicy._plan` at the small size with the learned cost:
  both sides draw the same latents, and every argmin that decides a frozen
  latent is held to its margin: the gap between the JAX side's best and
  second-best cost must exceed twice the largest difference between the two
  sides' costs, so that float error cannot have decided it. Then the same
  frozen latents, the plan's images within 2e-4 and latents within 5e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gcp_torch import tracing
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.models.hyperparameters import default_hparams as p_default_hparams
from video_gcp_torch.models.tree import TreeModel as PTree
from video_gcp_torch.planning import planner_policy as p_policy
from video_gcp_torch.planning import tree_optimizer as p_opt
from video_gcp_torch.planning.cem import cem_planner as p_cem
from video_gcp_torch.planning.cem import cost_fcn as p_cost
from video_gcp_torch.planning.cem import sampler as p_sampler
from video_gcp_torch.planning.cem.simulator import GCPImageSimulator as PSim
from video_gcp_torch.planning.run import load_control_config as p_load_control_config
from video_gcp_torch.training.checkpoint import flax_to_torch
from video_gcp_tpu.core.attrdict import AttrDict as JAttrDict
from video_gcp_tpu.models.aux_models import CostModel as JCostModel
from video_gcp_tpu.models.hyperparameters import default_hparams as j_default_hparams
from video_gcp_tpu.models.tree import TreeModel as JTree
from video_gcp_tpu.planning import planner_policy as j_policy
from video_gcp_tpu.planning import tree_optimizer as j_opt
from video_gcp_tpu.planning.cem import cem_planner as j_cem
from video_gcp_tpu.planning.cem import cost_fcn as j_cost
from video_gcp_tpu.planning.cem import sampler as j_sampler
from video_gcp_tpu.planning.cem.simulator import GCPImageSimulator as JSim
from video_gcp_tpu.planning.run import load_control_config as j_load_control_config
from video_gcp_tpu.training import checkpoint as j_ckpt

CONTROL = "experiments/control/9room/gcp_tree/mod_hyper.py"
WEIGHTS = "experiments/prediction/9room/gcp_tree/pretrained_ep74.npz"
L, IMG, T, NZ = 4, 16, 15, 8
TOLS = dict(images=2e-4, latents=5e-4, actions=1e-4, states=1e-4, seq_len_logits=1e-4)
TOL_COST = 1e-5  # relative to max(1, |cost|)
TOL_ACTION = 1e-4

SMALL_HP = dict(
    max_seq_len=T, img_sz=IMG, hierarchy_levels=L, matching_type="balanced",
    seq_enc="conv", tree_lstm="sum", regress_length=True, length_pred_weight=0.0,
    attach_inv_mdl=True, inv_mdl_params=dict(n_actions=2),
    attach_state_regressor=True, attach_cost_mdl=True, state_dim=2, n_actions=2,
    nz_vae=NZ)


def _hp(default_hparams, params):
    """PlannerPolicy's construction (planner_policy.py:56-61)."""
    params = dict(params)
    params["batch_size"] = 1
    params.setdefault("max_seq_len", 200)
    hp = default_hparams()
    hp.overwrite(params)
    return hp


@pytest.fixture(scope="module")
def small():
    """tests/test_planning.py's model with the cost model attached; weights
    from a seed in the flax structure of a training init (so that the
    inference and cost-model weights exist too)."""
    jmodel = JTree(hp=dict(_hp(j_default_hparams, SMALL_HP)))
    key = jax.random.PRNGKey(0)
    seq = jnp.zeros((2, T, IMG, IMG, 3))
    fake = JAttrDict(
        traj_seq=seq, I_0=seq[:, 0], I_g=seq[:, -1], end_ind=jnp.array([T - 1, T - 1]),
        pad_mask=jnp.ones((2, T)), actions=jnp.zeros((2, T - 1, 2)),
        traj_seq_states=jnp.zeros((2, T, 2)))  # no z: inference weights too
    shapes = jax.eval_shape(lambda i: jmodel.init({"params": key, "sample": key}, i,
                                                  "train", "posterior"), fake)
    rng = np.random.RandomState(0)

    def fill(path, s):
        if path[-1].key == "kernel":
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if path[-1].key == "scale":
            return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        return np.asarray(0.1 * rng.randn(*s.shape), np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    pmodel = PTree(dict(_hp(p_default_hparams, SMALL_HP)))
    pmodel.load_state_dict(flax_to_torch(params), strict=True)
    return jmodel, params, pmodel.eval()


@pytest.fixture(scope="module")
def ep74():
    params = dict(j_load_control_config(CONTROL)["policy"]["params"], length_pred_weight=0.0)
    jmodel = JTree(hp=dict(_hp(j_default_hparams, params)))
    jparams = j_ckpt.load_pretrained_npz(WEIGHTS)
    pparams = dict(p_load_control_config(CONTROL)["policy"]["params"], length_pred_weight=0.0)
    pmodel = PTree(dict(_hp(p_default_hparams, pparams)))
    assert p_policy.load_planner_weights(pmodel, WEIGHTS) == ["cost_mdl"]
    return jmodel, jparams, pmodel.eval()


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _compare_rollouts(pout, jout, latent_dim):
    assert len(pout.predictions) == len(jout.predictions)
    worst = dict(images=0.0, latents=0.0, actions=0.0, states=0.0)
    for i in range(len(jout.predictions)):
        p, j = pout.predictions[i], jout.predictions[i]
        assert p.shape == j.shape
        worst["images"] = max(worst["images"], _max_diff(p[:, :-latent_dim], j[:, :-latent_dim]))
        worst["latents"] = max(worst["latents"], _max_diff(p[:, -latent_dim:], j[:, -latent_dim:]))
        worst["actions"] = max(worst["actions"], _max_diff(pout.actions[i], jout.actions[i]))
        worst["states"] = max(worst["states"], _max_diff(pout.states[i], jout.states[i]))
    for k, v in worst.items():
        assert v < TOLS[k], (k, v)
    return worst


def _seq_len_logits(pmodel, jmodel, jparams, start, goal, z):
    inputs = dict(I_0=start, I_g=goal, z=z, end_ind=np.full(len(z), 10))
    jout = jax.jit(lambda p, i: jmodel.apply(p, i, "plan", "prior", True,
                                             rngs={"sample": jax.random.PRNGKey(0)}))(
        jparams, JAttrDict({k: jnp.asarray(v) for k, v in inputs.items()}))
    with torch.inference_mode():
        pout = pmodel(AttrDict({k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}),
                      phase="plan", mode="prior", pred_length=True,
                      generator=torch.Generator().manual_seed(0))
    assert np.array_equal(pout.end_ind.numpy(), np.full(len(z), 10))  # kept
    return _max_diff(pout.seq_len_logits, jout.seq_len_logits)


@pytest.mark.parametrize("which", ["small", "ep74"])
def test_simulator_matches_jax(which, request):
    jmodel, jparams, pmodel = request.getfixturevalue(which)
    img, n_nodes, nz, nz_enc, t = ((IMG, 2 ** L - 1, NZ, 32, T) if which == "small"
                                   else (32, 127, 256, 128, 100))
    rng = np.random.RandomState(0)
    state = rng.randint(0, 256, (1, img, img, 3)).astype(np.uint8)
    goal = rng.rand(1, img, img, 3).astype(np.float32)
    z = rng.randn(4 if which == "small" else 2, n_nodes, nz).astype(np.float32)
    jout = JSim(jmodel, jparams, append_latent=True).rollout(state, goal, z, t)
    psim = PSim(pmodel, append_latent=True)
    with tracing.session() as traced:
        pout = psim.rollout(state, goal, z, t)
    assert [p.shape[0] for p in pout.predictions] == [t] * len(z)  # end_ind kept
    _compare_rollouts(pout, jout, nz_enc)
    assert traced.counts["to_host.bytes.sim.outputs"] > 0
    s = np.repeat(state.astype(np.float32) / 127.5 - 1, len(z), 0)
    g = np.repeat(goal * 2 - 1, len(z), 0)
    assert _seq_len_logits(pmodel, jmodel, jparams, s, g, z) < TOLS["seq_len_logits"]


def _jax_cost_fn(params, cost_params=None):
    """The body of the JAX package's make_test_time_cost_fn, on params
    already loaded (its own loader reads orbax directories only)."""
    p = dict(nz_mid=128, n_processing_layers=3)
    p.update(cost_params or {})
    sub = j_ckpt.extract_subtree(params, "cost_mdl")
    model = JCostModel(p)
    run = jax.jit(lambda a, b: model.apply({"params": sub}, a, b))
    return lambda a, b: np.asarray(run(jnp.asarray(np.asarray(a), jnp.float32),
                                       jnp.asarray(np.asarray(b), jnp.float32)))


def test_learned_cost_matches_jax():
    jcost = j_cost.LearnedCostEstimate(dict(
        model_fn=_jax_cost_fn(j_ckpt.load_pretrained_npz(WEIGHTS)), input_dim=128))
    pcost = p_cost.LearnedCostEstimate(dict(checkpt_path=None, load_epoch=WEIGHTS,
                                            input_dim=128, device="cpu"))
    rng = np.random.RandomState(0)
    a, b = rng.randn(7, 128), rng.randn(7, 128)
    want, got = jcost(a, b), pcost(a, b)
    assert got.shape == want.shape == (7,)
    assert _max_diff(got, want) < TOL_COST * max(1.0, np.abs(want).max())
    seqs = [rng.randn(n, 128) for n in (3, 1, 9)]
    goals = [rng.randn(1, 128) for _ in seqs]
    want, got = jcost(seqs, goals), pcost(seqs, goals)
    assert _max_diff(got, want) < TOL_COST * max(1.0, np.abs(want).max())


def test_learned_cost_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_cost.LearnedCostEstimate(dict(checkpt_path=None, load_epoch=WEIGHTS))


@pytest.mark.parametrize("floor, window", [(0, 5), (2, 3), (4, 3), (3, 5), (0, 20)])
def test_localize_on_plan_matches_jax(floor, window):
    rng = np.random.RandomState(floor * 7 + window)
    plan = rng.randn(11, 4).astype(np.float32)
    for enc in (plan[3] + 1e-3, plan[9], plan[0], rng.randn(4).astype(np.float32)):
        jt, jn = j_policy.localize_on_plan(jnp.asarray(enc), jnp.asarray(plan),
                                           jnp.asarray(floor), window)
        pt, pn = p_policy.localize_on_plan(torch.from_numpy(enc), torch.from_numpy(plan),
                                           floor, window)
        assert (int(pt), int(pn)) == (int(jt), int(jn))


def _ag_params(device="cpu"):
    return dict(T=200, log_dir="/tmp", device=device)


def _port_policy(policy_conf, **over):
    conf = dict(policy_conf, **over)
    return conf["type"](_ag_params(), conf)


def test_planner_hparams_equal_jax():
    jconf = j_load_control_config(CONTROL)["policy"]["params"]
    pconf = p_load_control_config(CONTROL)["policy"]["params"]

    def plain(hp):
        out = {}
        for k, v in hp.items():
            if isinstance(v, type):
                out[k] = v.__name__  # the packages' classes differ by module
            elif isinstance(v, dict):
                out[k] = plain(v)
            else:
                out[k] = v
        return out

    assert plain(_hp(p_default_hparams, pconf)) == plain(_hp(j_default_hparams, jconf))


def test_infer_action_on_ep74_matches_jax():
    conf = p_load_control_config(CONTROL)["policy"]
    cem = dict(conf["cem_params"], cost_config=dict(conf["cem_params"]["cost_config"],
                                                    load_epoch=WEIGHTS))
    policy = _port_policy(conf, load_epoch=WEIGHTS, cem_params=cem)
    assert policy.dropped_subtrees == ["cost_mdl"]
    jp = j_policy.ImageCEMPolicy.__new__(j_policy.ImageCEMPolicy)
    jp._hp = jp._default_hparams()
    jp.planner = JTree(hp=dict(_hp(j_default_hparams,
                                   j_load_control_config(CONTROL)["policy"]["params"])))
    jp.params = j_ckpt.load_pretrained_npz(WEIGHTS)
    rng = np.random.RandomState(0)
    for _ in range(3):
        img = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
        target = rng.randn(128).astype(np.float32)
        got, want = policy._infer_action(img, target), jp._infer_action(img, target)
        assert got.shape == want.shape == (2,)
        assert _max_diff(got, want) < TOL_ACTION


class StubSim:
    """Rollouts as a fixed numpy function of the latents: lengths 3..T from
    the root latent, frames and latents from the node latents."""

    def __init__(self, latent_dim=6):
        self.d = latent_dim
        self.w = np.random.RandomState(7).randn(NZ, IMG * IMG * 3 + latent_dim) * 0.3

    def rollout(self, state, goal, samples, rollout_len):
        preds, lats = [], []
        for z in samples:
            n = 3 + int(abs(z[len(z) // 2, 0]) * 7) % (rollout_len - 2)
            rows = np.tanh(np.resize(z, (n, NZ)) @ self.w)
            preds.append(rows)
            lats.append(rows[:, -self.d:])
        return AttrDict(predictions=preds, latents=lats,
                        actions=[l[:-1, :2] for l in lats], states=[l[:, :2] for l in lats])


def test_optimizer_sampler_planner_match_jax_on_a_stub():
    def cost(a, b):
        return np.linalg.norm(np.asarray(a) - np.asarray(b), axis=-1, keepdims=True)

    rng = np.random.RandomState(0)
    state = rng.rand(1, IMG, IMG, 3).astype(np.float32)
    goal = rng.rand(1, IMG, IMG, 3).astype(np.float32)
    outs = []
    for cem, sampler in ((p_cem, p_sampler), (j_cem, j_sampler)):
        np.random.seed(3)
        planner = cem.HierarchicalImageCEMPlanner(dict(
            action_dim=NZ, n_iters=3, batch_size=8, max_rollout_bs=8,
            cost_config=dict(model_fn=cost, input_dim=6),
            sampler=sampler.ImageHierarchicalTreeCEMSampler,
            n_level_hierarchy=L, sampling_rates_per_layer=[4, 4],
            n_ll_samples=3, max_seq_len=T), StubSim())
        plan = planner(state, goal)
        opt = planner._sampler._optimizer
        outs.append((plan, opt._frozen_z.copy(), np.random.rand()))
    (pplan, pz, pnext), (jplan, jz, jnext) = outs
    assert np.array_equal(pz, jz) and pnext == jnext  # the same draws, in order
    for a, b in zip(pplan, jplan):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # the optimizer alone, on uneven rollouts
    for opt_mod in (p_opt, j_opt):
        np.random.seed(5)
        opt = opt_mod.HierarchicalTreeLatentOptimizer(3, [5], 3, p_cost.LearnedCostEstimate(
            dict(model_fn=cost, input_dim=4)), p_cost.LearnedCostEstimate(
            dict(model_fn=cost, input_dim=4)), 4)
        z = opt.sample()
        roll = [np.random.rand(n, 8) for n in (7, 2, 5, 7, 4)]
        res = opt.optimize(roll, np.random.rand(8))
        outs.append((z, res[0], res[1], opt.sample()))
    for a, b in zip(outs[-2], outs[-1]):
        assert np.array_equal(np.asarray(a), np.asarray(b))


class _ArgminLog:
    """numpy for tree_optimizer with np.argmin recorded: every cost vector
    that decides a frozen latent."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(np, name)

    def argmin(self, x, *args, **kwargs):
        self.calls.append(np.array(x, np.float64))
        return np.argmin(x, *args, **kwargs)


SMALL_CEM = AttrDict(prune_final=True, horizon=T, action_dim=NZ, n_iters=3, batch_size=8,
                    max_rollout_bs=8, n_level_hierarchy=L,
                    sampler=p_sampler.ImageHierarchicalTreeCEMSampler,
                    sampling_rates_per_layer=[4, 4], n_ll_samples=3,
                    cost_fcn=p_cost.ImageLearnedCostEstimate,
                    cost_config=AttrDict(input_dim=32, cost_params=AttrDict(nz_mid=32)))


@pytest.fixture(scope="module")
def small_policy(small, tmp_path_factory):
    """The port's ImageCEMPolicy on the small model, from a checkpoint."""
    exp = tmp_path_factory.mktemp("small_exp")
    (exp / "weights/weights_ep0").mkdir(parents=True)
    torch.save(dict(model=small[2].state_dict(), optimizer={}, step=0),
               exp / "weights/weights_ep0/state.pt")
    cem = AttrDict(SMALL_CEM, cost_config=AttrDict(SMALL_CEM.cost_config,
                                                   checkpt_path=str(exp)))
    return p_policy.ImageCEMPolicy(dict(_ag_params(), T=T), dict(
        params=SMALL_HP, checkpt_path=str(exp),
        cem_planner=p_cem.HierarchicalImageCEMPlanner, cem_params=cem,
        closed_loop_execution=True))


def test_localized_tracking_reads_the_window_at_every_call(small_policy):
    """tracking_window > 0: the window is the hparam's value at each call
    (the JAX package's jitted closure keeps the first one)."""
    policy = small_policy
    img = np.random.RandomState(0).randint(0, 256, (IMG, IMG, 3)).astype(np.uint8)
    with torch.inference_mode():
        enc = policy._encode(img)[0].numpy()
    offsets = np.array([3.0, 2.5, 2.0, 1.5, 1.0, 0.0, 0.5, 4.0, 5.0, 6.0, 7.0])
    policy.latent_plan = (enc[None] + offsets[:, None] / np.sqrt(enc.size)).astype(np.float32)
    floors = {}
    for window in (2, 6, 2):
        policy._hp.tracking_window = window
        policy._cursor_floor = 0
        action = policy.get_action(img)
        assert action.shape == (2,) and np.isfinite(action).all()
        floors.setdefault(window, []).append(policy._cursor_floor)
    assert floors == {2: [2, 2], 6: [5]}


def test_whole_plan_matches_jax(small, small_policy, monkeypatch):
    jmodel, params, _ = small
    policy = small_policy
    jcem = dict(SMALL_CEM, sampler=j_sampler.ImageHierarchicalTreeCEMSampler,
                cost_fcn=j_cost.ImageLearnedCostEstimate, max_seq_len=T,
                cost_config=dict(model_fn=_jax_cost_fn(params, dict(nz_mid=32)), input_dim=32))
    jp = j_policy.ImageCEMPolicy.__new__(j_policy.ImageCEMPolicy)
    jp._cem_planner = j_cem.HierarchicalImageCEMPlanner(
        jcem, JSim(jmodel, params, append_latent=True))

    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (IMG, IMG, 3)).astype(np.uint8)
    goal_image = rng.rand(1, IMG, IMG, 3).astype(np.float32)
    logs = {}
    for name, pol, mod in (("port", policy, p_opt), ("jax", jp, j_opt)):
        logs[name] = _ArgminLog()
        monkeypatch.setattr(mod, "np", logs[name])
        np.random.seed(11)
        pol._plan(image, goal_image, 0)
    pcalls, jcalls = logs["port"].calls, logs["jax"].calls
    assert len(pcalls) == len(jcalls) > 3
    for p, j in zip(pcalls, jcalls):
        fin = np.isfinite(j)
        assert np.array_equal(fin, np.isfinite(p))
        diff = float(np.abs(p[fin] - j[fin]).max())
        gap = np.diff(np.sort(j[fin])[:2])
        margin = float(gap[0]) if len(gap) else np.inf
        assert margin > 2 * diff, (margin, diff)  # float error cannot decide
        assert np.argmin(p) == np.argmin(j)
    popt = policy._cem_planner._sampler._optimizer
    jopt = jp._cem_planner._sampler._optimizer
    assert np.array_equal(popt._frozen_z, jopt._frozen_z)
    assert policy.image_plan.shape == np.asarray(jp.image_plan).shape
    assert _max_diff(policy.image_plan, jp.image_plan) < TOLS["images"]
    assert _max_diff(policy.latent_plan, jp.latent_plan) < TOLS["latents"]
    assert _max_diff(policy.action_plan, jp.action_plan) < TOLS["actions"]
    assert abs(float(policy.plan_cost) - float(jp.plan_cost)) < \
        TOL_COST * max(1.0, abs(float(jp.plan_cost))) + 1e-4
