"""The paper's planning baselines in the port against the JAX package, on
the CPU under one np.random seed:

- the flat CEM path: `FlatCEMSampler`, `PDDMSampler`,
  `SimpleTreeCEMSampler`, `CEMPlanner` and `ImageCEMPlanner` around a numpy
  stub simulator (identical numbers), `ImageWrappedLearnedCostFcn` on ep74's
  cost model, and one whole `_plan` of control/9room/gcp_sequential (the
  tree's latents as flat Gaussians, n_iters 1, batch 5, elite_frac 1.0) at
  tests/test_torch_planning.py's small size;
- the sequential planner: `GCPImageSimulator` over the VRNN and one flat CEM
  plan over its per-step latents (tests/test_planning.py:54-76, 174-191);
- VMPC: `ActCondGCPImageSimulator` (the samples are the actions) and
  `ImageCEMPolicy(act_cond=True, model_cls=SequentialModel)` planning over
  action sequences with a learned cost;
- `BehavioralCloningPolicy` from a port checkpoint, reactive and recurrent,
  and one BC control task through planning.run's ControlManager.

Every ranking that picks a plan is held to its margin: the gap between two
neighbouring costs of the JAX side must exceed twice the largest difference
between the two sides' costs, so that float error cannot have decided it.
Tolerances: rollout images 2e-4, latents 5e-4, actions and states 1e-4
(tests/test_torch_planning.py's TOLS); VMPC's rollouts VMPC_OUT_TOL
(tests/test_torch_variants.py: its zeroed goal image); costs 1e-5 relative
to max(1, |cost|); BC actions 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_planning import (
    NZ,
    TOL_COST,
    TOLS,
    WEIGHTS,
    StubSim,
    _ag_params,
    _hp,
    _jax_cost_fn,
    _max_diff,
    small,  # noqa: F401 (a fixture)
)
from test_torch_train import _seeded_params
from test_torch_variants import VMPC, VMPC_OUT_TOL
from video_gcp_torch.core.attrdict import AttrDict, load_pickle
from video_gcp_torch.models.hyperparameters import default_hparams as p_default_hparams
from video_gcp_torch.models.sequential import SequentialModel as PSeq
from video_gcp_torch.planning import planner_policy as p_policy
from video_gcp_torch.planning.cem import cem_planner as p_cem
from video_gcp_torch.planning.cem import cost_fcn as p_cost
from video_gcp_torch.planning.cem import sampler as p_sampler
from video_gcp_torch.planning.cem import simulator as p_sim
from video_gcp_torch.planning.infra.policy.bc_policy import BehavioralCloningPolicy
from video_gcp_torch.planning.run import ControlManager
from video_gcp_torch.planning.run import load_control_config as p_load_control_config
from video_gcp_torch.training.checkpoint import flax_to_torch
from video_gcp_tpu.core.attrdict import AttrDict as JAttrDict
from video_gcp_tpu.models.bc import BCModel as JBC
from video_gcp_tpu.models.hyperparameters import default_hparams as j_default_hparams
from video_gcp_tpu.models.sequential import SequentialModel as JSeq
from video_gcp_tpu.planning import planner_policy as j_policy
from video_gcp_tpu.planning.cem import cem_planner as j_cem
from video_gcp_tpu.planning.cem import cost_fcn as j_cost
from video_gcp_tpu.planning.cem import sampler as j_sampler
from video_gcp_tpu.planning.cem import simulator as j_sim
from video_gcp_tpu.planning.infra.policy import bc_policy as j_bc_policy
from video_gcp_tpu.planning.run import load_control_config as j_load_control_config
from video_gcp_tpu.training import checkpoint as j_ckpt

SEQ_CONTROL = "experiments/control/9room/gcp_sequential/mod_hyper.py"
IMG, T = 16, 15  # tests/test_torch_planning.py's small size
TOL_BC = 1e-5


class CostLog:
    """Records the cost vectors a planner ranks, on each side, so that each
    ranking can be held to its margin."""

    def __init__(self, monkeypatch, classes):
        self.calls = []
        for cls in classes:
            orig = cls.__call__

            def call(obj, *a, _orig=orig, **kw):
                out = _orig(obj, *a, **kw)
                self.calls.append(np.array(out, np.float64))
                return out
            monkeypatch.setattr(cls, "__call__", call)


def _check_rankings(pcalls, jcalls, n_ranked):
    """The first `n_ranked` places of every ranking are beyond float error,
    and the same on both sides."""
    assert len(pcalls) == len(jcalls) > 0
    for p, j in zip(pcalls, jcalls):
        assert p.shape == j.shape
        diff = float(np.abs(p - j).max())
        assert diff < TOL_COST * max(1.0, np.abs(j).max()), diff
        gaps = np.diff(np.sort(j))[:n_ranked]
        assert gaps.min(initial=np.inf) > 2 * diff, (gaps, diff)
        assert np.array_equal(np.argsort(p)[:n_ranked], np.argsort(j)[:n_ranked])


# ---------------------------------------------------------------------------
# the flat CEM path around a stub
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["FlatCEMSampler", "PDDMSampler", "SimpleTreeCEMSampler"])
def test_flat_samplers_match_jax(name):
    outs = []
    for mod in (p_sampler, j_sampler):
        np.random.seed(4)
        kw = dict(n_level_hierarchy=3) if name == "SimpleTreeCEMSampler" else {}
        sampler = getattr(mod, name)(1.5, 6, 3, 0.3, **kw)
        first = sampler.sample(8)
        sampler.fit(first[:4], np.linspace(0.5, 2.0, 4))
        second = sampler.sample(5)
        dists = sampler.get_dists()
        sampler.init()
        outs.append((first, second, dists.mean, dists.std, sampler.sample(2),
                     np.random.rand()))
    for a, b in zip(*outs):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert outs[0][0].shape == ((8, 7, 3) if name == "SimpleTreeCEMSampler" else (8, 6, 3))
    assert np.abs(outs[0][1]).max() <= 1.5  # clipped


def _wrapped_cost(cost_mod, config):
    """ImageWrappedLearnedCostFcn for the flat planners, which build their
    cost from (dense_cost, final_step_weight) alone: the config binds the
    learned cost's own parameters, as a control config's class does."""

    class Cost(cost_mod.ImageWrappedLearnedCostFcn):
        def __init__(self, *unused):
            super().__init__(config)
    return Cost


@pytest.mark.parametrize("planner", ["CEMPlanner", "ImageCEMPlanner"])
def test_flat_cem_planner_matches_jax_on_a_stub(planner):
    def cost(a, b):
        return np.linalg.norm(np.asarray(a) - np.asarray(b), axis=-1, keepdims=True)

    rng = np.random.RandomState(0)
    state = rng.rand(1, IMG, IMG, 3).astype(np.float32)
    goal = rng.rand(1, IMG, IMG, 3).astype(np.float32)
    outs = []
    for cem, sampler, cost_mod in ((p_cem, p_sampler, p_cost), (j_cem, j_sampler, j_cost)):
        np.random.seed(3)
        planner_obj = getattr(cem, planner)(dict(
            action_dim=NZ, n_iters=3, batch_size=8, max_rollout_bs=3, elite_frac=0.25,
            sampler=sampler.FlatCEMSampler if planner == "CEMPlanner"
            else sampler.PDDMSampler,
            cost_fcn=_wrapped_cost(cost_mod, dict(model_fn=cost, input_dim=6)),
            max_seq_len=T, horizon=T - 2, use_inferred_actions=planner == "CEMPlanner"),
            StubSim())
        plan = planner_obj(state, goal)
        outs.append((plan, planner_obj._call_logs[-1][-1].elite_scores, np.random.rand()))
    (pplan, pscores, pnext), (jplan, jscores, jnext) = outs
    assert pnext == jnext  # the same draws, in order
    assert np.array_equal(pscores, jscores)
    for a, b in zip(pplan, jplan):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_image_wrapped_learned_cost_matches_jax():
    """ep74's cost model on image+latent rollouts; the last rollout's
    latents are every rollout's goal (cost_fcn.py:108-117)."""
    jcost = j_cost.ImageWrappedLearnedCostFcn(dict(
        model_fn=_jax_cost_fn(j_ckpt.load_pretrained_npz(WEIGHTS)), input_dim=128))
    pcost = p_cost.ImageWrappedLearnedCostFcn(dict(
        checkpt_path=None, load_epoch=WEIGHTS, input_dim=128, device="cpu"))
    rng = np.random.RandomState(0)
    rolls = [rng.randn(n, 8 * 8 * 3 + 128).astype(np.float32) for n in (4, 9, 1, 6)]
    want, got = jcost(rolls, None), pcost(rolls, None)
    assert got.shape == want.shape == (4,)
    assert _max_diff(got, want) < TOL_COST * max(1.0, np.abs(want).max())
    assert np.array_equal(pcost.image_rollouts(rolls)[1], jcost.image_rollouts(rolls)[1])


def test_gcp_sequential_control_config_matches_jax():
    """control/9room/gcp_sequential: the flat ablation's planner settings
    through both config loaders."""
    jconf = j_load_control_config(SEQ_CONTROL)["policy"]
    pconf = p_load_control_config(SEQ_CONTROL)["policy"]
    assert pconf["cem_params"]["sampler"] is p_sampler.SimpleTreeCEMSampler
    assert pconf["cem_params"]["cost_fcn"] is p_cost.ImageWrappedLearnedCostFcn
    assert pconf["cem_planner"] is p_cem.HierarchicalImageCEMPlanner
    for k in ("n_iters", "batch_size", "elite_frac", "n_level_hierarchy", "horizon",
              "action_dim", "prune_final"):
        assert pconf["cem_params"][k] == jconf["cem_params"][k], k

    def plain(hp):
        return {k: v.__name__ if isinstance(v, type) else plain(v) if isinstance(v, dict)
                else v for k, v in hp.items()}

    assert plain(_hp(p_default_hparams, pconf["params"])) == \
        plain(_hp(j_default_hparams, jconf["params"]))


@pytest.fixture(scope="module")
def small_exp(small, tmp_path_factory):
    exp = tmp_path_factory.mktemp("small_exp")
    (exp / "weights/weights_ep0").mkdir(parents=True)
    torch.save(dict(model=small[2].state_dict(), optimizer={}, step=0),
               exp / "weights/weights_ep0/state.pt")
    return exp


def test_whole_gcp_sequential_plan_matches_jax(small, small_exp, monkeypatch):
    """One `_plan` with control/9room/gcp_sequential's CEM (the tree's 2^L - 1
    latents as flat Gaussians, n_iters 1, batch 5, elite_frac 1.0, the
    wrapped learned cost) on the small tree model."""
    from test_torch_planning import SMALL_HP

    jmodel, params, _ = small
    cem = dict(prune_final=True, horizon=T, action_dim=NZ, n_iters=1, batch_size=5,
               elite_frac=1.0, n_level_hierarchy=4)
    policy = p_policy.ImageCEMPolicy(dict(_ag_params(), T=T), dict(
        params=SMALL_HP, checkpt_path=str(small_exp),
        cem_planner=p_cem.HierarchicalImageCEMPlanner,
        cem_params=AttrDict(cem, sampler=p_sampler.SimpleTreeCEMSampler,
                            cost_fcn=p_cost.ImageWrappedLearnedCostFcn,
                            cost_config=AttrDict(checkpt_path=str(small_exp), input_dim=32,
                                                 cost_params=AttrDict(nz_mid=32))),
        closed_loop_execution=True))
    jp = j_policy.ImageCEMPolicy.__new__(j_policy.ImageCEMPolicy)
    jp._cem_planner = j_cem.HierarchicalImageCEMPlanner(
        dict(cem, sampler=j_sampler.SimpleTreeCEMSampler,
             cost_fcn=j_cost.ImageWrappedLearnedCostFcn, max_seq_len=T,
             cost_config=dict(model_fn=_jax_cost_fn(params, dict(nz_mid=32)), input_dim=32)),
        j_sim.GCPImageSimulator(jmodel, params, append_latent=True))
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (IMG, IMG, 3)).astype(np.uint8)
    goal_image = rng.rand(1, IMG, IMG, 3).astype(np.float32)
    logs, nexts = {}, {}
    for name, pol, cost_mod in (("port", policy, p_cost), ("jax", jp, j_cost)):
        logs[name] = CostLog(monkeypatch, [cost_mod.ImageWrappedLearnedCostFcn])
        np.random.seed(11)
        pol._plan(image, goal_image, 0)
        nexts[name] = np.random.rand()
    assert nexts["port"] == nexts["jax"]
    _check_rankings(logs["port"].calls, logs["jax"].calls, n_ranked=1)  # the best one
    assert policy.image_plan.shape == np.asarray(jp.image_plan).shape
    assert _max_diff(policy.image_plan, jp.image_plan) < TOLS["images"]
    assert _max_diff(policy.latent_plan, jp.latent_plan) < TOLS["latents"]
    assert _max_diff(policy.action_plan, jp.action_plan) < TOLS["actions"]
    assert abs(float(policy.plan_cost) - float(jp.plan_cost)) < \
        TOL_COST * max(1.0, abs(float(jp.plan_cost)))


# ---------------------------------------------------------------------------
# the sequential planner and VMPC
# ---------------------------------------------------------------------------

# length_pred_weight 0: the 'plan' call keeps the given end_ind, as in
# tests/test_torch_planning.py, since torch cannot replay JAX's length draw
SEQ_HP = dict(max_seq_len=T, img_sz=IMG, hierarchy_levels=0, regress_length=True,
              length_pred_weight=0.0,
              attach_inv_mdl=True, inv_mdl_params=dict(n_actions=2),
              attach_state_regressor=True, state_dim=2, n_actions=2, nz_vae=NZ,
              attach_cost_mdl=True)


def _seq_pair(over):
    """The VRNN of tests/test_planning.py:54-76 (with the cost model), with
    weights from a seed in the structure of a training init, and its twin."""
    hp = dict(_hp(j_default_hparams, dict(SEQ_HP, **over)))
    jmodel = JSeq(hp=hp)
    rng = np.random.RandomState(0)
    seq = (rng.rand(2, T, IMG, IMG, 3) * 2 - 1).astype(np.float32)
    batch = JAttrDict(traj_seq=jnp.asarray(seq), I_0=jnp.asarray(seq[:, 0]),
                      I_g=jnp.asarray(seq[:, -1]), end_ind=jnp.array([T - 1, T - 1]),
                      pad_mask=jnp.ones((2, T)), actions=jnp.zeros((2, T - 1, 2)),
                      traj_seq_states=jnp.zeros((2, T, 2)))
    params = _seeded_params(jmodel, batch)
    pmodel = PSeq(dict(_hp(p_default_hparams, dict(SEQ_HP, **over))))
    pmodel.load_state_dict(flax_to_torch(params), strict=True)
    return jmodel, params, pmodel.eval()


def _compare_rollouts(pout, jout, latent_dim, tols):
    assert len(pout.predictions) == len(jout.predictions)
    for i in range(len(jout.predictions)):
        p, j = pout.predictions[i], jout.predictions[i]
        assert p.shape == j.shape
        assert _max_diff(p[:, :-latent_dim], j[:, :-latent_dim]) < tols["images"]
        assert _max_diff(p[:, -latent_dim:], j[:, -latent_dim:]) < tols["latents"]
        assert _max_diff(pout.actions[i], jout.actions[i]) < tols["actions"]
        assert _max_diff(pout.states[i], jout.states[i]) < tols["states"]


class L2Cost:
    """L2ImageCost of each package with the small model's latent width
    (a subclass: the class attribute stays as it is for other tests)."""

    def __new__(cls, cost_mod):
        return type("L2", (cost_mod.L2ImageCost,), {"LATENT_SIZE": 32})


def test_sequential_planner_matches_jax(monkeypatch):
    """GCPImageSimulator over the VRNN with injected per-step latents, then
    flat CEM over them (tests/test_planning.py:174-191)."""
    jmodel, params, pmodel = _seq_pair({})
    rng = np.random.RandomState(0)
    state = rng.rand(1, IMG, IMG, 3).astype(np.float32)
    goal = rng.rand(1, IMG, IMG, 3).astype(np.float32)
    z = rng.randn(3, T, NZ).astype(np.float32)
    jout = j_sim.GCPImageSimulator(jmodel, params, append_latent=True).rollout(state, goal, z, T)
    pout = p_sim.GCPImageSimulator(pmodel, append_latent=True).rollout(state, goal, z, T)
    _compare_rollouts(pout, jout, 32, TOLS)

    plans, logs = [], {}
    for name, cem, cost_mod, sim in (
            ("port", p_cem, p_cost, p_sim.GCPImageSimulator(pmodel, append_latent=True)),
            ("jax", j_cem, j_cost, j_sim.GCPImageSimulator(jmodel, params, append_latent=True))):
        cost = L2Cost(cost_mod)
        logs[name] = CostLog(monkeypatch, [cost])
        np.random.seed(7)
        planner = cem.CEMPlanner(dict(action_dim=NZ, n_iters=2, batch_size=6, max_rollout_bs=6,
                                      elite_frac=0.5, cost_fcn=cost, dense_cost=False,
                                      max_seq_len=T, horizon=T), sim)
        plans.append(planner(state, goal) + (np.random.rand(),))
    # 3 elites of 6, in order; the final re-rollout's scores are not ranked
    _check_rankings(logs["port"].calls, logs["jax"].calls, n_ranked=3)
    (pp, pa, pl, ps, pn), (jp_, ja, jl, js, jn) = plans
    assert pn == jn
    assert np.asarray(pp).shape[1] == IMG * IMG * 3 + 32
    assert _max_diff(pp, jp_) < TOLS["latents"]
    assert _max_diff(pa, ja) < TOLS["actions"]
    assert abs(float(ps) - float(js)) < TOL_COST * max(1.0, abs(float(js)))


# VMPC draws a length and replaces it by max_seq_len - 1 (base.py:get_end_ind)
VMPC_SEQ = dict(VMPC, img_sz=IMG, max_seq_len=T, length_pred_weight=1.0)
VMPC_TOLS = dict(images=VMPC_OUT_TOL, latents=VMPC_OUT_TOL, actions=VMPC_OUT_TOL,
                 states=VMPC_OUT_TOL)


def test_act_cond_simulator_matches_jax():
    """The samples are the actions, the pad mask ones, no z: the predicted
    length is max_seq_len - 1 whatever the draw."""
    jmodel, params, pmodel = _seq_pair(VMPC_SEQ)
    rng = np.random.RandomState(1)
    state = rng.randint(0, 256, (1, IMG, IMG, 3)).astype(np.uint8)
    goal = rng.rand(1, IMG, IMG, 3).astype(np.float32)
    acts = (rng.randn(3, T, 2) * 0.3).astype(np.float32)
    jout = j_sim.ActCondGCPImageSimulator(jmodel, params, append_latent=True).rollout(
        state, goal, acts, T)
    psim = p_sim.ActCondGCPImageSimulator(pmodel, append_latent=True)
    inputs = psim._prep_inputs(state, goal, acts, T)
    assert "z" not in inputs and inputs.pad_mask.shape == (3, T) and bool(inputs.pad_mask.all())
    pout = psim.rollout(state, goal, acts, T)
    assert [p.shape[0] for p in pout.predictions] == [T] * 3
    _compare_rollouts(pout, jout, 32, VMPC_TOLS)


@pytest.fixture(scope="module")
def vmpc_exp(tmp_path_factory):
    jmodel, params, pmodel = _seq_pair(VMPC_SEQ)
    exp = tmp_path_factory.mktemp("vmpc_exp")
    (exp / "weights/weights_ep0").mkdir(parents=True)
    torch.save(dict(model=pmodel.state_dict(), optimizer={}, step=0),
               exp / "weights/weights_ep0/state.pt")
    return jmodel, params, exp


def test_vmpc_policy_plans_over_actions_like_jax(vmpc_exp, monkeypatch):
    """ImageCEMPolicy(act_cond=True, model_cls=SequentialModel) with
    ImageCEMPlanner, FlatCEMSampler over [T, 2] action sequences and the
    wrapped learned cost; the plan executes the best sampled actions."""
    jmodel, params, exp = vmpc_exp
    cem = dict(horizon=T, action_dim=2, n_iters=2, batch_size=6, elite_frac=0.5,
               use_inferred_actions=False)
    policy = p_policy.ImageCEMPolicy(dict(_ag_params(), T=T), dict(
        params=dict(VMPC_SEQ, **{k: v for k, v in SEQ_HP.items() if k not in VMPC_SEQ}),
        checkpt_path=str(exp), cem_planner=p_cem.ImageCEMPlanner, act_cond=True,
        model_cls=PSeq, cem_params=dict(cem, cost_fcn=_wrapped_cost(p_cost, dict(
            checkpt_path=str(exp), input_dim=32, cost_params=dict(nz_mid=32),
            device="cpu")))))
    assert isinstance(policy.planner, PSeq)
    assert type(policy._cem_simulator) is p_sim.ActCondGCPImageSimulator
    jp = j_policy.ImageCEMPolicy.__new__(j_policy.ImageCEMPolicy)
    jp._cem_planner = j_cem.ImageCEMPlanner(
        dict(cem, max_seq_len=T, cost_fcn=_wrapped_cost(j_cost, dict(
            model_fn=_jax_cost_fn(params, dict(nz_mid=32)), input_dim=32))),
        j_sim.ActCondGCPImageSimulator(jmodel, params, append_latent=True))
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (IMG, IMG, 3)).astype(np.uint8)
    goal_image = rng.rand(1, IMG, IMG, 3).astype(np.float32)
    logs, nexts = {}, {}
    for name, pol, cost_mod in (("port", policy, p_cost), ("jax", jp, j_cost)):
        logs[name] = CostLog(monkeypatch, [cost_mod.ImageWrappedLearnedCostFcn])
        np.random.seed(5)
        pol._plan(image, goal_image, 0)
        nexts[name] = np.random.rand()
    assert nexts["port"] == nexts["jax"]
    _check_rankings(logs["port"].calls, logs["jax"].calls, n_ranked=3)
    assert np.asarray(policy.action_plan).shape == (T, 2)
    assert np.array_equal(policy.action_plan, jp.action_plan)  # the same sampled actions
    assert _max_diff(policy.image_plan, jp.image_plan) < VMPC_OUT_TOL
    assert _max_diff(policy.latent_plan, jp.latent_plan) < VMPC_OUT_TOL
    policy.current_exec_step = 3
    assert np.array_equal(policy.get_action(image), policy.action_plan[3])


# ---------------------------------------------------------------------------
# behavioral cloning
# ---------------------------------------------------------------------------

BC_HP = dict(n_actions=2, img_sz=IMG, max_seq_len=T, nz_mid_lstm=16, n_lstm_layers=2)


def _bc_checkpoint(tmp_path, reactive):
    hp = j_default_hparams()
    hp.overwrite(dict(BC_HP, batch_size=1, reactive=reactive))
    jmodel = JBC(hp=dict(hp))
    rng = np.random.RandomState(0)
    seq = (rng.rand(1, T, IMG, IMG, 3) * 2 - 1).astype(np.float32)
    params = _seeded_params(jmodel, JAttrDict(
        traj_seq=jnp.asarray(seq), I_g=jnp.asarray(seq[:, -1]),
        actions=jnp.zeros((1, T - 1, 2)), pad_mask=jnp.ones((1, T))))
    exp = tmp_path / f"bc_{reactive}"
    (exp / "weights/weights_ep3").mkdir(parents=True)
    torch.save(dict(model=flax_to_torch(params), optimizer={}, step=3),
               exp / "weights/weights_ep3/state.pt")
    return jmodel, params, exp


@pytest.mark.parametrize("reactive", [True, False])
def test_bc_policy_matches_jax(tmp_path, reactive):
    jmodel, params, exp = _bc_checkpoint(tmp_path, reactive)
    policyparams = dict(params=dict(BC_HP, reactive=reactive), checkpt_path=str(exp))
    policy = BehavioralCloningPolicy(_ag_params(), policyparams)
    jp = j_bc_policy.BehavioralCloningPolicy.__new__(j_bc_policy.BehavioralCloningPolicy)
    jp._hp = jp._default_hparams()
    jp.model, jp.params, jp.hidden_var = jmodel, params, None
    jp._run = jax.jit(lambda p, a, b, h: jmodel.apply(p, a, b, h, method=JBC.act_single))
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (5, 1, IMG, IMG, 3)).astype(np.uint8)  # [T, cam, ...]
    goal_image = rng.randint(0, 256, (2, 1, IMG, IMG, 3)).astype(np.uint8)  # 5 dims
    for t in range(3):
        got = policy.act(t=t, i_tr=0, images=images, goal_image=goal_image).actions
        want = jp.act(t=t, i_tr=0, images=images, goal_image=goal_image).actions
        assert got.shape == (2,) and _max_diff(got, want) < TOL_BC
        assert (policy.hidden_var is None) == reactive
    policy.reset()
    assert policy.hidden_var is None
    assert np.array_equal(policy.default_action, np.zeros(2))
    for img in (images[0], images[0] / 255.0, images[0] / 127.5 - 1):
        assert np.array_equal(policy._preprocess_input(img), jp._preprocess_input(img))


def test_bc_policy_runs_on_the_card_by_default(tmp_path, monkeypatch):
    _, _, exp = _bc_checkpoint(tmp_path, True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BehavioralCloningPolicy(dict(T=T), dict(params=dict(BC_HP), checkpt_path=str(exp)))


BC_CONTROL = """
import os.path

from video_gcp_tpu.core.attrdict import AttrDict
from video_gcp_tpu.planning.infra.agent.general_agent import BenchmarkAgent
from video_gcp_tpu.planning.infra.envs.multiroom2d import TopdownMultiroom2dEnv
from video_gcp_tpu.planning.infra.policy.bc_policy import BehavioralCloningPolicy

current_dir = os.path.dirname(os.path.realpath(__file__))
agent = AttrDict(
    type=BenchmarkAgent,
    env=(TopdownMultiroom2dEnv, dict(init_pos=None, goal_pos=None, n_rooms=9,
                                     heading_smoothing=0.1, crop_window=40)),
    T=40, image_height=16, image_width=16,
    start_goal_confs=os.environ['GCP_DATA_DIR'] + '/nav_9rooms/start_goal_configs/raw',
)
policy = AttrDict(type=BehavioralCloningPolicy, params=PARAMS, checkpt_path=CHECKPT)
config = AttrDict(current_dir=current_dir, start_index=0, end_index=0, agent=agent,
                  policy=policy, save_format=['raw'],
                  data_save_dir=os.environ['GCP_EXP_DIR'] + '/control/bc',
                  split_train_val_test=False, traj_per_file=1)
"""


def test_bc_control_task_on_the_cpu(tmp_path, monkeypatch):
    """One task of the 9-room env driven by the recurrent BC policy through
    planning.run's ControlManager."""
    from test_torch_control import DATA_GEN, _copy_config

    _, _, exp = _bc_checkpoint(tmp_path, False)
    monkeypatch.setenv("GCP_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path / "exp"))
    ControlManager([str(_copy_config(DATA_GEN, tmp_path)), "--device", "cpu",
                    "--start_idx", "0", "--end_idx", "0"]).run()
    conf = tmp_path / "experiments/control/bc/mod_hyper.py"
    conf.parent.mkdir(parents=True)
    conf.write_text(BC_CONTROL.replace("PARAMS", repr(dict(BC_HP, reactive=False)))
                    .replace("CHECKPT", repr(str(exp))))
    ControlManager([str(conf), "--device", "cpu"]).run()
    task = load_pickle(conf.parent / "log/task_0.pkl")
    traj = np.asarray(task["full_traj"], np.float64)
    assert 1 < len(traj) <= 41 and np.isfinite(traj).all()
    assert (conf.parent / "log/results_0to0.txt").is_file()
