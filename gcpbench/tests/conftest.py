"""The benchmark's own tests: `python -m pytest gcpbench/tests -q` from the
checkout's root. Tests marked `cuda` decide inside the test whether a card
is there and skip without one."""
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("OMP_NUM_THREADS", "2")

# a cell cut to a size the CPU runs in seconds; the widths stay in proportion
TINY = dict(hierarchy_levels=3, ngf=4, nz_enc=16, nz_mid=16, nz_mid_lstm=16, nz_vae=8,
            max_seq_len=8)
TINY_MIX = dict(batch=2, seq_len=8, pool_batches=8, lengths=dict(full=0.5, min=3))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny_cell(name: str, **mix):
    from gcpbench import spec
    cell = spec.load_cell(name, ROOT)
    cell.mix = dict(cell.mix, **TINY_MIX, **mix)
    return cell
