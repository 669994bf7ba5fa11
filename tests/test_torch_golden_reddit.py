"""The golden accuracy floors of maxk_tpu_torch on the CPU: the reddit rows (4×256, scale 0.004).

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
    for gc in GOLDEN if gc.dataset in ("reddit",)
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


def _row_values(package: str, row: str, seeds, threads: int):
    """(seed, best_val, best_test, seconds) of golden row `row` for each
    seed, trained on the CPU by `package` ("torch": the port's `run_golden`
    on `threads` torch threads; "jax": the JAX package's `run_golden` with
    its module's SEED set to the seed)."""
    import time

    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from maxk_tpu.train import golden as jgold

        gc = next(g for g in jgold.GOLDEN if row_id(g) == row)
    else:
        torch.set_num_threads(threads)
        gc = next(g for g in GOLDEN if row_id(g) == row)
    for seed in seeds:
        t0 = time.perf_counter()
        if package == "jax":
            jgold.SEED = seed
            best_val, best_test = jgold.run_golden(gc)
        else:
            best_val, best_test = run_golden(gc, device="cpu", seed=seed)
        yield seed, float(best_val), float(best_test), time.perf_counter() - t0


if __name__ == "__main__":
    # One golden row (any of the ten; default reddit MaxK, the ROADMAP C
    # entry) over seeds, in either package, on the CPU: one JSON line a seed.
    #   python tests/test_torch_golden_reddit.py --package jax --seeds 97 1 2
    #   python tests/test_torch_golden_reddit.py --package torch --seeds 97 1 2
    #   python tests/test_torch_golden_reddit.py --package torch --seeds 97 \
    #       --row flickr-sage-maxk --threads 1
    # XLA's eigen runtime on one thread unless XLA_FLAGS says otherwise, as
    # the port's runs take one torch thread by default.
    import argparse
    import json
    import os

    p = argparse.ArgumentParser()
    p.add_argument("--package", choices=("jax", "torch"), required=True)
    p.add_argument("--row", default="reddit-sage-maxk")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--threads", type=int, default=1, help="torch threads (the port)")
    a = p.parse_args()
    os.environ.setdefault("XLA_FLAGS", "--xla_cpu_multi_thread_eigen=false")
    for seed, val, test, secs in _row_values(a.package, a.row, a.seeds, a.threads):
        print(json.dumps({"package": a.package, "row": a.row, "seed": seed, "threads": a.threads,
                          "best_val": val, "best_test": test, "seconds": secs}), flush=True)
