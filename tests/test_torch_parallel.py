"""Multi-device training and candidate-sharded planning of the PyTorch port
against the JAX package's sharded step, on the CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py: its
`make_train_step(model, make_mesh(2))` (data parallel) and, with `state=`,
over `make_mesh(n, ("data", "model"), shape)` (dp x fsdp). The port's ranks
are spawned processes under one gloo process group per world size
(tests/test_torch_parallel_ranks.py, which imports torch and the port only); each
takes its `batch_rows` of the global batch and of every noise draw
(`SharedNoise`, recorded once from the global batch: every draw is
batch-leading, one normal per tree level and 2 + 2 uniforms).

- `param_shardings` picks JAX's dimension for every array of a tree.
- One step at 2 ranks data parallel, 1 x 2 and 2 x 2 dp x fsdp (the large
  parameters split over 'model' by the port's FSDP): losses, gradients,
  grad_norm, grads_finite and the updated parameters against the JAX step
  on a mesh of the same shape and against the port's own single-process
  step on the whole batch; every rank ends with the same parameters.
- A NaN in one rank's rows zeroes every rank's update.
- The ranks' loader rows make up the single-process global batches.
- A checkpoint crosses world sizes strictly: single process -> 1 x 2
  dp x fsdp -> single process.
- The simulator split over ["cpu", "cpu"] equals the unsplit one, with an
  odd candidate count (JAX's test_mesh_rollout_matches_single_device).
- ModelTrainer on 2 ranks of a gloo group, as torchrun starts it: a 2-step
  run in which only rank 0 prints and writes; without --deterministic the
  ranks of a 'model' group draw the same noise, data shards different noise.

Tolerances: tests/test_torch_train.py's (loss terms 1e-5 relative to
max(1, |value|), gradients 1e-4 relative to max(1e-3, max |jax|) per
parameter, parameters after one step 1e-6 absolute, grad_norm 1e-4
relative). The split simulator draws the same lengths and its outputs are
held at 1e-5 absolute (SPLIT_TOL): not bit for bit, because the CPU's
kernels block their work by the batch size (a chunk of 3 rows against a
call of 5 differ by up to 8.2e-7).
"""
import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import test_torch_parallel_ranks as ranks
from test_torch_train import (
    GRAD_TOL,
    KEY,
    LOSS_TOL,
    PARAM_TOL,
    SharedNoise,
    _jax_batch,
    _jax_grad_fn,
    _seeded_params,
    _torch_batch,
    default_hparams,
)
from video_gcp_torch.models.tree import TreeModel as TorchTree
from video_gcp_torch.parallel.mesh import batch_rows, param_shardings
from video_gcp_torch.parallel.train_step import make_optimizer, train_step
from video_gcp_torch.planning.cem.simulator import GCPImageSimulator
from video_gcp_torch.training import checkpoint as ckpt
from video_gcp_tpu.models.tree import TreeModel as JaxTree
from video_gcp_tpu.parallel import mesh as j_mesh
from video_gcp_tpu.parallel import train_step as j_train_step
from video_gcp_tpu.training import checkpoint as j_ckpt

REPO = Path(__file__).resolve().parent.parent
B, T, IMG, LR = 4, 10, 16, 1e-3
MIN_SHARD = 2 ** 12  # the port's FSDP floor here, so that the small model splits
NAN_ROW = 3  # a row of rank 1 of 2
SPLIT_TOL = 1e-5  # split vs unsplit simulator outputs, absolute
HP = dict(batch_size=B, max_seq_len=T, img_sz=IMG, hierarchy_levels=3,
          matching_type="balanced", regress_length=True, attach_state_regressor=True,
          state_dim=2, attach_inv_mdl=True, inv_mdl_params=dict(n_actions=2),
          attach_cost_mdl=True, n_actions=2, seq_enc="conv", one_step_planner="sh_pred",
          decoder_distribution="discrete_logistic_mixture", tree_lstm="split_linear",
          lstm_init="mlp", untied_layers=True)


def _hp():
    hp = default_hparams()
    hp.overwrite(HP)
    return dict(hp)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    seq = (rng.rand(B, T, IMG, IMG, 3) * 2 - 1).astype(np.float32)
    end_ind = np.array([T - 1, 6, T - 1, 5], np.int32)
    pad = (np.arange(T)[None] <= end_ind[:, None]).astype(np.float32)
    return dict(traj_seq=seq, I_0=seq[:, 0], I_g=seq[np.arange(B), end_ind],
                end_ind=end_ind, pad_mask=pad,
                actions=rng.randn(B, T - 1, 2).astype(np.float32) * 0.1,
                traj_seq_states=rng.rand(B, T, 2).astype(np.float32))


def _max_rel(got, want, floor):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(floor, float(np.abs(want).max(initial=0.0)))
    return float(np.abs(got - want).max(initial=0.0)) / scale


def _jax_steps(jmodel, params, batch, bad_batch, noise):
    """The JAX references: the gradients of the whole batch, and one step of
    `make_train_step` on a 2-device data mesh and on ('data', 'model') meshes
    of shapes (1, 2) and (2, 2) with `state=`, each as (its metrics, the new
    parameters in the port's layout); the data mesh's step also on
    `bad_batch`. Traced one after another under the shared noise, compiled
    side by side."""
    jb = _jax_batch(batch)

    tx = j_train_step.make_optimizer("radam", LR, None, 0, 0.9)

    def state():  # one optimizer object: it is static in the state's pytree
        return j_train_step.TrainState.create(params, tx)

    meshes = dict(dp2=(j_mesh.make_mesh(2), False),
                  fsdp12=(j_mesh.make_mesh(2, ("data", "model"), (1, 2)), True),
                  fsdp22=(j_mesh.make_mesh(4, ("data", "model"), (2, 2)), True))
    lowered = dict(grad=noise.run(lambda: _jax_grad_fn(jmodel).lower(params, jb)))
    for name, (mesh, sharded) in meshes.items():
        s = state()
        step = j_train_step.make_train_step(jmodel, mesh, state=s if sharded else None)
        lowered[name] = noise.run(lambda: step.lower(s, jb, KEY))
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = dict(zip(lowered, pool.map(lambda lo: lo.compile(), lowered.values())))
    (_, _), grads = compiled["grad"](params, jb)
    out = dict(grads=ckpt.flax_to_torch(jax.device_get(grads)))
    runs = [(name, name, jb) for name in meshes] + [("nan_dp2", "dp2", _jax_batch(bad_batch))]
    for name, program, b in runs:
        new_state, met = compiled[program](state(), b, KEY)
        out[name] = (jax.device_get(met), ckpt.flax_to_torch(jax.device_get(new_state.params)))
    return out


def _start(world, workdir, spec):
    os.makedirs(workdir)
    torch.save(spec, os.path.join(workdir, "spec.pt"))
    return mp.start_processes(ranks.session, args=(world, workdir), nprocs=world,
                              join=False, start_method="spawn")


def _results(ctx, world, workdir):
    while not ctx.join():
        pass
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


TRAINER_CONF = "experiments/prediction/toy_random/gcp_tree"


def _trainer_argv(deterministic):
    return ["--path", str(REPO / TRAINER_CONF), "--feed_random_data", "1", "--num_epochs", "1",
            "--val_metric_batches", "1", "--deterministic", str(int(deterministic)),
            "--device", "cpu", "--resume", "none"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Everything the tests compare: the model, its seeded weights, the
    global batch and the recorded noise; the port's single-process step on
    the whole batch, with its checkpoint; the JAX gradients and sharded
    steps; and the results of every rank of a 2-rank and a 4-rank gloo
    session, which run while JAX compiles."""
    hp, batch = _hp(), _batch()
    jmodel = JaxTree(hp=hp)
    params = _seeded_params(jmodel, _jax_batch(batch))
    weights = ckpt.flax_to_torch(params)
    tmp = tmp_path_factory.mktemp("parallel")
    out = dict(hp=hp, batch=batch, params=params, weights=weights, tmp=tmp)
    bad = dict(batch, traj_seq=batch["traj_seq"].copy())
    bad["traj_seq"][NAN_ROW, 3, 2, 2, 0] = np.nan
    with pytest.MonkeyPatch.context() as mpatch:
        noise = SharedNoise(mpatch)
        model = TorchTree(hp)
        model.load_state_dict(weights, strict=True)
        opt = make_optimizer([p for p in model.parameters() if p.requires_grad],
                             "radam", LR, None, 0, 0.9)
        met = noise.run(train_step, model, opt, _torch_batch(batch), 0, torch.Generator())
        out["single"] = dict(
            metrics=met, params={k: v.clone() for k, v in model.state_dict().items()},
            grads={n: p.grad.clone() for n, p in model.named_parameters() if p.requires_grad})
        out["single_ckpt"] = ckpt.save_checkpoint(tmp / "single", 0, model, opt, 1)
        spec = dict(hp=hp, weights=weights, batch=batch, lr=LR, noise=noise.draws)
        cases2 = dict(
            dp2=dict(kind="step", mesh=(2, 1)),
            fsdp12=dict(kind="step", mesh=(1, 2), min_shard_size=MIN_SHARD),
            nan_dp2=dict(kind="step", mesh=(2, 1), nan_row=NAN_ROW),
            loader_even=dict(kind="loader", n=12, batch_size=4, drop_last=True, seed=3),
            loader_short=dict(kind="loader", n=11, batch_size=4, drop_last=False, seed=3),
            checkpoint=dict(kind="checkpoint", mesh=(1, 2), min_shard_size=MIN_SHARD,
                            load=out["single_ckpt"], exp_path=str(tmp / "fsdp_exp")))
        for name, fsdp, run in (("trainer", 1, True), ("trainer_dp2_clock", 1, False),
                                ("trainer_fsdp12_clock", 2, False)):
            cases2[name] = dict(kind="trainer", fsdp=fsdp, run=run, n_seqs=8, clock_skew=5,
                                exp_dir=str(tmp / name), argv=_trainer_argv(run))
        cases4 = dict(fsdp22=dict(kind="step", mesh=(2, 2), min_shard_size=MIN_SHARD))
        sessions = [(w, str(tmp / f"world{w}"), dict(spec, cases=c))
                    for w, c in ((2, cases2), (4, cases4))]
        running = [_start(*s) for s in sessions]
        try:
            out["jax"] = _jax_steps(jmodel, params, batch, bad, noise)
        finally:
            for (w, workdir, _), ctx in zip(sessions, running):
                out[f"world{w}"] = _results(ctx, w, workdir)
    return out


@pytest.fixture(scope="module")
def world2(ref):
    return ref["world2"]


@pytest.fixture(scope="module")
def world4(ref):
    return ref["world4"]


# ---------------------------------------------------------------------------
# the sharding rule
# ---------------------------------------------------------------------------

def _jax_dims(tree, model_axis, min_size):
    mesh = j_mesh.make_mesh(2 * model_axis if model_axis > 1 else 2, ("data", "model"),
                            (2, model_axis))
    specs = j_mesh.param_shardings(mesh, tree, min_shard_size=min_size)
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    out = {}
    for path, sharding in flat:
        spec = tuple(sharding.spec)
        out["/".join(p.key for p in path)] = spec.index("model") if "model" in spec else None
    return out


@pytest.mark.parametrize("tree,model_axis,min_size", [
    ("small", 2, 2 ** 10), ("small", 4, 2 ** 10), ("small", 2, 2 ** 15),
    ("ep74", 2, 2 ** 15), ("ep74", 4, 2 ** 15), ("ep74", 1, 2 ** 15)])
def test_param_shardings_match_jax(ref, tree, model_axis, min_size):
    params = (ref["params"] if tree == "small" else j_ckpt.load_pretrained_npz(
        REPO / "experiments/prediction/9room/gcp_tree/pretrained_ep74.npz"))
    want = _jax_dims(params, model_axis, min_size)
    shapes = {"/".join(p.key for p in path): np.shape(a) for path, a in
              jax.tree_util.tree_flatten_with_path(params)[0]}
    got = param_shardings(shapes, model_axis, min_size)
    assert got == want
    n_split = sum(d is not None for d in got.values())
    assert n_split == 0 if model_axis == 1 or (tree, min_size) == ("small", 2 ** 15) else n_split


def test_batch_rows():
    assert [batch_rows(r, 4, 16) for r in range(4)] == [
        slice(0, 4), slice(4, 8), slice(8, 12), slice(12, 16)]
    with pytest.raises(ValueError, match="does not split"):
        batch_rows(0, 3, 16)


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

def _check_step(ref, results, name):
    j_met, j_params = ref["jax"][name]
    single = ref["single"]
    r0 = results[0][name]
    for k, v in j_met.items():
        if np.ndim(v) == 0 and k not in ("grads_finite", "grad_norm"):
            want = float(v)
            assert abs(float(r0["metrics"][k]) - want) < LOSS_TOL * max(1.0, abs(want)), k
            want = float(single["metrics"][k])
            assert abs(float(r0["metrics"][k]) - want) < LOSS_TOL * max(1.0, abs(want)), k
    assert bool(r0["metrics"]["grads_finite"]) and bool(j_met["grads_finite"])
    assert abs(float(r0["metrics"]["grad_norm"]) - float(j_met["grad_norm"])) <= (
        1e-4 * float(j_met["grad_norm"]))
    np.testing.assert_allclose(r0["metrics"]["kl_layerwise"].numpy(), j_met["kl_layerwise"],
                               rtol=1e-5, atol=1e-6)
    vs_jax = {n: _max_rel(g, ref["jax"]["grads"][n], 1e-3) for n, g in r0["grads"].items()}
    vs_single = {n: _max_rel(g, single["grads"][n], 1e-3) for n, g in r0["grads"].items()}
    for worst in (vs_jax, vs_single):
        assert max(worst.values()) < GRAD_TOL, max(worst, key=worst.get)
    param_d = 0.0
    for k, v in r0["params"].items():
        d = max(float(np.abs(v.numpy().astype(np.float64) - j_params[k].numpy()).max()),
                float((v - single["params"][k]).abs().max()))
        assert d < PARAM_TOL, k
        param_d = max(param_d, d)
    print(name, "worst gradient vs JAX", max(vs_jax.values()), max(vs_jax, key=vs_jax.get),
          "vs one process", max(vs_single.values()), "parameters", param_d)
    for other in results[1:]:  # every rank holds the same global metrics and weights
        for k, v in r0["params"].items():
            assert torch.equal(v, other[name]["params"][k]), k
        for k, v in r0["metrics"].items():
            assert torch.equal(v, other[name]["metrics"][k]), k


def test_data_parallel_step_matches_jax(ref, world2):
    _check_step(ref, world2, "dp2")
    rows = [r["dp2"]["local_rows"] for r in world2]
    assert rows == [(0, 2), (2, 4)]
    assert all(d is None for d in world2[0]["dp2"]["shard_dims"].values())
    assert world2[0]["dp2"]["foreach"] is None  # torch's default


@pytest.mark.parametrize("name", ["fsdp12", "fsdp22"])
def test_dp_fsdp_step_matches_jax(ref, world2, world4, name):
    results = world2 if name == "fsdp12" else world4
    _check_step(ref, results, name)
    model = TorchTree(ref["hp"])
    want = param_shardings(dict(model.named_parameters()), 2, MIN_SHARD)
    got = results[0][name]["shard_dims"]
    assert got == want  # sharded where the JAX rule shards, whole elsewhere
    assert sum(d is not None for d in got.values()) >= 5
    assert any(d not in (None, 0) for d in got.values())  # not only dim 0
    # split and whole parameters side by side: the multi-tensor kernels,
    # which refuse such a mix, are off
    assert results[0][name]["foreach"] is False


def test_nan_in_one_rank_zeroes_every_update(ref, world2):
    j_met, j_params = ref["jax"]["nan_dp2"]
    assert not bool(j_met["grads_finite"])
    for rank in world2:
        res = rank["nan_dp2"]
        assert not bool(res["metrics"]["grads_finite"])
        assert float(res["metrics"]["grad_norm"]) == 0.0 == float(j_met["grad_norm"])
        assert all(float(g.abs().sum()) == 0.0 for g in res["grads"].values())
        for k, v in res["params"].items():  # RAdam's first step on zeros moves nothing
            assert torch.equal(v, ref["weights"][k].reshape(v.shape)), k
            assert float(np.abs(v.numpy() - j_params[k].numpy()).max()) < PARAM_TOL


# ---------------------------------------------------------------------------
# the loader's rows and checkpoints across world sizes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["loader_even", "loader_short"])
def test_loader_rows_make_the_global_batch(world2, case):
    spec = dict(loader_even=(12, True), loader_short=(11, False))[case]
    single = ranks.DataLoader(ranks._Examples(spec[0]), 4, shuffle=True,
                              drop_last=spec[1], num_workers=1, seed=3)
    epochs = [[b["y"].numpy() for b in single] for _ in range(2)]
    per_rank = [r[case] for r in world2]
    for e, batches in enumerate(epochs):
        assert len(per_rank[0][e]) == len(per_rank[1][e]) == len(batches)
        for i, whole in enumerate(batches):
            if len(whole) % 2:  # a short final batch: every rank takes it whole
                assert case == "loader_short"
                assert all(np.array_equal(r[e][i], whole) for r in per_rank)
            else:
                assert np.array_equal(np.concatenate([r[e][i] for r in per_rank]), whole)
    assert not np.array_equal(np.concatenate(epochs[0]), np.concatenate(epochs[1]))


def _assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}/{i}")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_checkpoint_crosses_world_sizes(ref, world2):
    res = world2[0]["checkpoint"]
    # single process -> 1 x 2 dp x fsdp: every tensor as written
    single = torch.load(os.path.join(ref["single_ckpt"], ckpt.STATE_FILE), weights_only=True)
    _assert_same(res["loaded"]["model"], single["model"], "model")
    _assert_same(res["loaded"]["optimizer"], single["optimizer"], "optimizer")
    assert res["loaded"]["step"] == 1
    assert any(d is not None for d in res["shard_dims"].values())
    # 1 x 2 dp x fsdp, one more step, written by rank 0 -> single process
    path = os.path.join(ref["tmp"], "fsdp_exp", "weights", "weights_ep1")
    model = TorchTree(ref["hp"])
    opt = make_optimizer([p for p in model.parameters() if p.requires_grad], "radam", LR,
                         None, 0, 0.9)
    assert ckpt.load_checkpoint(path, model, opt) == 2
    _assert_same(model.state_dict(), res["params"], "model")
    _assert_same(opt.state_dict(), res["optimizer"], "optimizer")
    assert {float(opt.state[p]["step"]) for p in opt.state} == {2.0}
    moved = [k for k, v in single["model"].items() if not torch.equal(model.state_dict()[k], v)]
    assert len(moved) > len(single["model"]) // 2  # the sharded run stepped


# ---------------------------------------------------------------------------
# candidate-sharded planning
# ---------------------------------------------------------------------------

def test_split_simulator_matches_unsplit(ref):
    model = TorchTree(ref["hp"]).eval()
    model.load_state_dict(ref["weights"], strict=True)
    rng = np.random.RandomState(3)
    state = rng.rand(1, IMG, IMG, 3).astype(np.float32)
    goal = rng.rand(1, IMG, IMG, 3).astype(np.float32)
    whole = GCPImageSimulator(model, append_latent=True)
    split = GCPImageSimulator(model, append_latent=True, devices=["cpu", "cpu"])
    ends = []
    for n in (5, 4, 1):  # 5 % 2 != 0: padded to 6
        z = rng.randn(n, 2 ** 3 - 1, ref["hp"]["nz_vae"]).astype(np.float32)
        want, got = whole.rollout(state, goal, z, T), split.rollout(state, goal, z, T)
        assert split._pad_bucket == n + n % 2 and split._pad_bucket % 2 == 0
        assert len(got.predictions) == n
        for key in ("predictions", "actions", "states", "latents"):
            for a, b in zip(want[key], got[key]):
                assert a.shape == b.shape, key  # the same lengths
                assert np.abs(a - b).max() < SPLIT_TOL, key
        ends += [len(p) for p in want.predictions]
    assert len(set(ends)) > 1  # the lengths were drawn, not fixed


def test_planning_mesh_devices(monkeypatch):
    from video_gcp_torch.planning.planner_policy import planning_mesh_devices
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = torch.device("cuda")
    assert planning_mesh_devices(4, cuda) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert planning_mesh_devices(1, cuda) is None
    assert planning_mesh_devices(0, cuda) is None
    assert planning_mesh_devices(2, torch.device("cpu")) is None


# ---------------------------------------------------------------------------
# the trainer under torchrun
# ---------------------------------------------------------------------------

def test_torchrun_trainer_two_ranks(ref, world2):
    """ModelTrainer on 2 ranks of one gloo group, as torchrun starts it:
    2 steps of toy_random/gcp_tree; only rank 0 prints and writes."""
    res = [r["trainer"] for r in world2]
    assert [r["mesh"] for r in res] == [(2,), (2,)] and [r["step"] for r in res] == [2, 2]
    assert res[0]["stdout"].count("model parameters:") == 1
    assert res[0]["stdout"].count("epoch 0 it 0/2") == 1
    assert res[1]["stdout"] == ""
    exp = ref["tmp"] / "trainer" / "prediction/toy_random/gcp_tree"
    events = sorted(p.name for p in (exp / "events").iterdir())
    assert events == ["events.jsonl", "images"], events  # the log and rank 0's val images
    records = [json.loads(line) for line in open(exp / "events/events.jsonl")]
    tags = [r["tag"] for r in records if "file" in r]
    assert tags and len(tags) == len(set(tags)), tags  # each image logged once
    assert ckpt.get_epochs(exp) == [0]
    from video_gcp_torch.training.config import build_hparams, load_config
    model = TorchTree(build_hparams(load_config(REPO / TRAINER_CONF)))
    opt = make_optimizer([p for p in model.parameters() if p.requires_grad], "radam")
    assert ckpt.load_checkpoint(exp / "weights/weights_ep0", model, opt) == 2


def test_trainer_noise_without_deterministic(world2):
    """Seeded from rank 0's clock, though the ranks' clocks read 5 s apart:
    the two ranks of a 'model' group draw the same noise, two data shards
    different noise."""
    fsdp = [r["trainer_fsdp12_clock"] for r in world2]
    assert [r["mesh"] for r in fsdp] == [(1, 2), (1, 2)]
    assert torch.equal(fsdp[0]["noise"], fsdp[1]["noise"])
    dp = [r["trainer_dp2_clock"] for r in world2]
    assert [r["mesh"] for r in dp] == [(2,), (2,)]
    assert not torch.equal(dp[0]["noise"], dp[1]["noise"])
