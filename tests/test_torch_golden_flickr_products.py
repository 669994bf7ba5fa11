"""The golden accuracy floors of maxk_tpu_torch on the CPU: the flickr (3×256, scale 0.05) and ogbn-products (3×256, scale 0.0004) rows.

Each row trains through `run_golden(gc, device="cpu")` (the plain PyTorch
path) and must reach `best_val >= min_val`, the JAX package's floor. The
rows are split over three files so that xdist's `--dist loadfile` runs
them on three workers. A row of `golden.KNOWN_MISSES` is a ROADMAP C
entry and runs as `xfail(strict=True)`. The torch thread count is set for
each test (matrix products round by it, so a row's value depends on it).
"""

import pytest
import torch

from maxk_tpu_torch.train.golden import GOLDEN, KNOWN_MISSES, row_id, run_golden

pytestmark = pytest.mark.golden

THREADS = 2
ROWS = [
    pytest.param(gc, id=row_id(gc), marks=[
        pytest.mark.xfail(strict=True, reason=KNOWN_MISSES[row_id(gc)])
    ] if row_id(gc) in KNOWN_MISSES else [])
    for gc in GOLDEN if gc.dataset in ("flickr", "ogbn-products")
]


@pytest.fixture(autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("gc", ROWS)
def test_golden_floor(gc):
    best_val, _ = run_golden(gc, device="cpu")
    assert best_val >= gc.min_val, (
        f"{row_id(gc)}: best_val {best_val:.4f} under the golden floor {gc.min_val} "
        f"(scale {gc.scale}, lr {gc.lr}, {gc.epochs} epochs, {gc.hidden_layers}x{gc.hidden_dim})"
    )
