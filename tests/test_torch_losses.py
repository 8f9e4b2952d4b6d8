"""The port's loss records, Gaussian helpers, DLM NLL, schedules and the
train path's small ops against the JAX package, on the CPU in f32 with
seeded inputs.

Tolerances: 1e-6 relative to max(1, |value|) for the loss values and
breakdowns (f32 sums in different orders); the DLM NLL per pixel 1e-2
absolute, because both frameworks' f32 `sigmoid(plus) - sigmoid(minus)`
cancels where the bin mass is small: each is off by up to ~8.5e-3 from a
float64 evaluation at the same points (checked below), in different places.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gcp_torch.core import losses as t_losses
from video_gcp_torch.core import schedules as t_sched
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.core.distributions import Gaussian as TGaussian
from video_gcp_torch.core.distributions import safe_entropy as t_safe_entropy
from video_gcp_torch.models import dlm as t_dlm
from video_gcp_torch.models.aux_models import CostModel as TCost
from video_gcp_torch.ops import tree_index as t_ti
from video_gcp_tpu.core import losses as j_losses
from video_gcp_tpu.core import schedules as j_sched
from video_gcp_tpu.core.attrdict import AttrDict as JAttrDict
from video_gcp_tpu.core.distributions import Gaussian as JGaussian
from video_gcp_tpu.core.distributions import safe_entropy as j_safe_entropy
from video_gcp_tpu.models import dlm as j_dlm
from video_gcp_tpu.models.aux_models import CostModel as JCost
from video_gcp_tpu.ops import tree_index as j_ti

TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(a)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    d = float(np.abs(got.astype(np.float64) - want).max(initial=0.0)) / scale
    assert d < tol, d


def _same_term(t_term, j_term):
    _close(t_term.value, j_term.value)
    assert (t_term.breakdown is None) == (j_term.breakdown is None)
    if t_term.breakdown is not None:
        _close(t_term.breakdown, j_term.breakdown)
    _close(t_term.error_mat, j_term.error_mat)
    assert float(t_term.weight) == pytest.approx(float(j_term.weight))


def _rng(seed=0):
    return np.random.RandomState(seed)


@pytest.mark.parametrize("breakdown", [None, 1, 2])
def test_l2_loss(breakdown):
    r = _rng()
    a, b = r.randn(3, 5, 4).astype(np.float32), r.randn(3, 5, 4).astype(np.float32)
    w = (r.rand(3, 5, 1) > 0.3).astype(np.float32)
    _same_term(t_losses.l2_loss(_t(a), _t(b), _t(w), 0.5, breakdown),
               j_losses.l2_loss(_j(a), _j(b), _j(w), 0.5, breakdown))


@pytest.mark.parametrize("free_nats", [0.0, 0.3])
def test_kl_divergence_loss(free_nats):
    r = _rng(1)
    mu_q, ls_q, mu_p, ls_p = (r.randn(2, 7, 6).astype(np.float32) for _ in range(4))
    got = t_losses.kl_divergence_loss(TGaussian(_t(mu_q), _t(ls_q)),
                                      TGaussian(_t(mu_p), _t(ls_p)), weight=2.0,
                                      free_nats_per_dim=free_nats, breakdown=1)
    want = j_losses.kl_divergence_loss(JGaussian(_j(mu_q), _j(ls_q)),
                                       JGaussian(_j(mu_p), _j(ls_p)), weight=2.0,
                                       free_nats_per_dim=free_nats, breakdown=1)
    _same_term(got, want)


def test_gaussian_entropy_nll_and_safe_entropy():
    r = _rng(2)
    mu, ls, x = (r.randn(4, 5).astype(np.float32) for _ in range(3))
    tg, jg = TGaussian(_t(mu), _t(ls)), JGaussian(_j(mu), _j(ls))
    _close(tg.entropy(), jg.entropy())
    _close(tg.nll(_t(x)), jg.nll(_j(x)))
    p = r.rand(3, 7, 10).astype(np.float32)
    p[0, 0] = 0.0  # log(0 + eps) path
    p[1, 2] = np.eye(10)[3]
    _close(t_safe_entropy(_t(p), -1), j_safe_entropy(_j(p), -1))


def test_bce_and_ce_logits_loss():
    r = _rng(3)
    logits = (r.randn(4, 15) * 5).astype(np.float32)
    target = (r.rand(4, 15) > 0.5).astype(np.float32)
    _same_term(t_losses.bce_logits_loss(_t(logits), _t(target)),
               j_losses.bce_logits_loss(_j(logits), _j(target)))
    idx = r.randint(0, 15, 4).astype(np.int32)
    _same_term(t_losses.ce_logits_loss(_t(logits), _t(idx), weight=0.7),
               j_losses.ce_logits_loss(_j(logits), _j(idx), weight=0.7))


@pytest.mark.parametrize("reduction,breakdown", [(None, None), ([-1, -2], 1),
                                                 (None, 2)])
def test_penalty_loss(reduction, breakdown):
    v = _rng(4).randn(3, 6, 4, 5).astype(np.float32)
    _same_term(t_losses.penalty_loss(_t(v), 1.5, breakdown, reduction),
               j_losses.penalty_loss(_j(v), 1.5, breakdown, reduction))


def test_gaussian_nll_loss():
    r = _rng(5)
    a, b = r.randn(2, 5, 4, 4, 3).astype(np.float32), r.randn(2, 5, 4, 4, 3).astype(np.float32)
    w = np.ones((2, 5, 1, 1, 1), np.float32)
    w[1, 3:] = 0
    ls = np.float32(-0.3)
    _same_term(t_losses.gaussian_nll_loss(_t(a), _t(b), torch.tensor(ls), _t(w)),
               j_losses.gaussian_nll_loss(_j(a), _j(b), _j(ls), _j(w)))


def test_total_loss_skips_log_only_terms():
    r = _rng(6)
    vals = r.rand(4).astype(np.float32)
    weights = [1.0, 0.0, 0.5, -1.0]
    t_terms = AttrDict({f"t{i}": t_losses.LossTerm(_t(v), w)
                        for i, (v, w) in enumerate(zip(vals, weights))})
    j_terms = JAttrDict({f"t{i}": j_losses.LossTerm(_j(v), w)
                         for i, (v, w) in enumerate(zip(vals, weights))})
    # a tensor weight of 0 still counts (a ramped KL weight at step 0)
    nan = np.float32(np.nan)
    t_terms.ramp = t_losses.LossTerm(torch.tensor(nan), t_sched.kl_weight_at(0, 1.0, 10))
    j_terms.ramp = j_losses.LossTerm(_j(nan), j_sched.kl_weight_at(0, 1.0, 10))
    assert np.isnan(float(t_losses.total_loss(t_terms, 48)))
    del t_terms["ramp"], j_terms["ramp"]
    _close(t_losses.total_loss(t_terms, 48), j_losses.total_loss(j_terms, 48))
    assert float(t_losses.total_loss(t_terms, 48)) == pytest.approx(
        (vals[0] + 0.5 * vals[2]) / 48)


@pytest.mark.parametrize("step,burn_in", [(0, None), (7, None), (0, 10), (3, 10),
                                          (10, 10), (25, 10)])
def test_kl_weight_at(step, burn_in):
    got = t_sched.kl_weight_at(step, 0.8, burn_in)
    want = j_sched.kl_weight_at(jnp.asarray(step, jnp.int32), 0.8, burn_in)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def _dlm_inputs(seed, n=3000, scale=2.0):
    r = _rng(seed)
    raw = (r.randn(n, 70) * scale).astype(np.float32)
    tgt = (r.randint(0, 256, (n, 3)) / 127.5 - 1).astype(np.float32)
    return raw, tgt


def test_dlm_nll_matches_jax_and_float64():
    raw, tgt = _dlm_inputs(7)
    got = t_dlm.nll(_t(raw), _t(tgt)).numpy()
    want = np.asarray(j_dlm.nll(_j(raw), _j(tgt)))
    f64 = t_dlm.nll(_t(raw).double(), _t(tgt).double()).numpy()
    assert np.abs(got - want).max() < 1e-2
    # both f32 evaluations are equally far from float64
    err_t, err_j = np.abs(got - f64), np.abs(want - f64)
    assert err_t.max() < 1e-2 and err_j.max() < 1e-2
    assert err_t.mean() < 2 * err_j.mean()


def test_dlm_nll_branches():
    """Edge bins (x = -1, +1), tiny bin masses (the mid-bin density branch:
    small scales far from the target) and ordinary bins, each against JAX."""
    n_mix, c = t_dlm.N_MIX, 3
    r = _rng(8)
    raw = np.zeros((6, n_mix * (1 + 2 * c)), np.float32)
    raw[:, :n_mix] = r.randn(6, n_mix)
    means = raw[:, n_mix:n_mix + n_mix * c].reshape(6, n_mix, c)
    scales = raw[:, n_mix + n_mix * c:].reshape(6, n_mix, c)
    tgt = np.array([[-1.0, 1.0, 0.0]] * 3 + [[0.5, -0.2, 0.9]] * 3, np.float32)
    means[:] = 0.1 * r.randn(6, n_mix, c)
    scales[:] = -1.0
    scales[3:] = -7.0  # sharp components
    means[3:] = 3.0  # tanh(3) ~ 0.995, far from the targets: cdf_delta < 1e-5
    got = t_dlm.nll(_t(raw), _t(tgt))
    want = j_dlm.nll(_j(raw), _j(tgt))
    _close(got, want, 1e-5)
    inv_s = np.exp(7.0)
    mean = np.tanh(3.0)
    with np.errstate(over="ignore"):
        cdf = [1 / (1 + np.exp(-inv_s * (tgt[3:, None] - mean + h)))
               for h in (1 / 255, -1 / 255)]
    delta = cdf[0] - cdf[1]
    assert (delta <= 1e-5).all()  # the mid-bin branch did run


def test_cost_model_targets_match_jax(monkeypatch):
    """sample_targets with the same two uniform draws on both sides."""
    r = _rng(9)
    b, t = 4, 12
    enc = r.randn(b, t, 8).astype(np.float32)
    traj = r.randn(b, t, 5, 5, 3).astype(np.float32)
    end = np.array([11, 5, 2, 8], np.int32)
    u = [r.rand(b).astype(np.float32) for _ in range(2)]
    draws = iter(u)
    monkeypatch.setattr(jax.random, "uniform", lambda k, shape, *a, **kw: _j(next(draws)))
    j_start, j_end, j_cost = JCost.sample_targets(
        jax.random.PRNGKey(0), _j(enc), _j(traj), _j(end))
    t_draws = iter(u)
    monkeypatch.setattr("video_gcp_torch.core.distributions.uniform",
                        lambda shape, g, device=None: _t(next(t_draws)))
    start, stop, cost = TCost.sample_targets(None, _t(enc), _t(traj), _t(end))
    _close(start, j_start)
    _close(stop, j_end)
    _close(cost, j_cost, 1e-5)


@pytest.mark.parametrize("depth", [1, 3, 7])
def test_per_level_means(depth):
    x = _rng(depth).randn(2 ** depth - 1).astype(np.float32)
    _close(t_ti.per_level_means(_t(x)), j_ti.per_level_means(_j(x)))
    for a, b in zip(t_ti.split_by_layer_bf(_t(x[None]), 1),
                    j_ti.split_by_layer_bf(_j(x[None]), 1)):
        _close(a, b)
