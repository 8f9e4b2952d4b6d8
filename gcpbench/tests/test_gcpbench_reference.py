"""The reference against the program on the CPU at a tiny size: the same
weights, inputs and noise give the same losses, gradients, prior images and
evaluation. (This test imports both; the reference itself imports nothing
of the program.)"""
import ast
from pathlib import Path

import pytest
import torch

from gcpbench import generate, weights
from gcpbench.reference import model as ref
from gcpbench.tests.conftest import ROOT, TINY

CONFIGS = ["gcp_tree.9room", "gcp_tree.25room_long"]


def _models(name):
    from gcpbench import program
    from gcpbench.spec import read_json
    config = read_json(ROOT / f"gcpbench/configs/{name}.json")
    prog, hp = program.build_model(ROOT, config, "cpu", TINY)
    reference = ref.build(hp, "cpu")
    for m in (prog, reference):
        weights.assign(m, 11)
    return prog, reference, hp


def _batch(hp, rows=2):
    mix = dict(seq_len=hp["max_seq_len"], batch=rows, pool_batches=1,
               lengths=dict(full=0.5, min=3))
    return generate.sequences(mix, hp["img_sz"], rows, 3, "cpu")


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "gcpbench/reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("video_gcp_torch", "video_gcp_tpu", "jax",
                                               "flax", "optax", "gcpbench"), (path, n)


@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_matches(name):
    from video_gcp_torch.core.attrdict import AttrDict
    from video_gcp_torch.parallel.train_step import make_optimizer, train_step
    prog, reference, hp = _models(name)
    prog.train(), reference.train()
    batches = [_batch(hp) for _ in range(2)]
    opt_p = make_optimizer([p for p in prog.parameters() if p.requires_grad], "radam", 2e-4)
    opt_r = ref.RAdam([p for p in reference.parameters() if p.requires_grad], 2e-4)
    gp, gr = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    for step, batch in enumerate(batches):
        m = train_step(prog, opt_p, AttrDict(batch), step, gp)
        loss, _ = ref.train_step(reference, opt_r, batch, step, gr)
        assert float(m.total) == pytest.approx(float(loss), rel=1e-5)
    for (n, a), b in zip(prog.named_parameters(), reference.parameters()):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-7), n


@pytest.mark.parametrize("name", CONFIGS)
def test_prior_forward_matches(name):
    from video_gcp_torch.core.attrdict import AttrDict
    prog, reference, hp = _models(name)
    batch = _batch(hp)
    prior = {k: batch[k] for k in ("I_0", "I_g", "end_ind")}
    with torch.no_grad():
        a = prog(AttrDict(prior), phase="test", mode="prior",
                 generator=torch.Generator().manual_seed(2))
        b = reference(ref.AttrDict(prior), phase="test", mode="prior",
                      generator=torch.Generator().manual_seed(2))
    assert torch.allclose(a.tree.images, b.tree.images, atol=1e-5)
    assert torch.equal(a.prune_keep, b.prune_keep)


def test_radam_is_torchs():
    torch.manual_seed(0)
    p1 = torch.nn.Parameter(torch.randn(5, 3))
    p2 = torch.nn.Parameter(p1.detach().clone())
    opt1, opt2 = torch.optim.RAdam([p1], lr=1e-2, betas=(0.9, 0.999), eps=1e-8), ref.RAdam([p2], 1e-2)
    for step in range(8):  # past the steps whose variance is intractable
        g = torch.randn(5, 3)
        p1.grad, p2.grad = g.clone(), g.clone()
        opt1.step(), opt2.step()
        assert torch.allclose(p1, p2, rtol=1e-5, atol=1e-7), step


def test_evaluation_matches():
    from video_gcp_torch.core.attrdict import AttrDict
    from video_gcp_torch.evaluation.evaluator import Evaluator
    from gcpbench.reference import evaluate
    prog, reference, hp = _models("gcp_tree.25room_long")
    prog.eval(), reference.eval()
    batch = _batch(hp, rows=3)
    ev = Evaluator(prog, str(Path(__import__("tempfile").mkdtemp())), hp, hp["max_seq_len"],
                   pruning_scheme="pruned_dtw", top_of_100=True)
    got = ev.eval(AttrDict(batch), torch.Generator().manual_seed(9)).metrics
    want = evaluate.sample_metrics(reference, batch, torch.Generator().manual_seed(9), 100,
                                   [0, 2], "pruned_dtw", hp["max_seq_len"], chunk=30)
    for k in ("mse", "psnr", "ssim"):
        assert got[k][[0, 2]] == pytest.approx(want[k], rel=1e-5), k
    assert want["match"].shape == (2, 100, hp["max_seq_len"])
