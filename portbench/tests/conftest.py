"""The benchmark's own tests: `python -m pytest portbench/tests -q` on the CPU;
the `cuda`-marked ones run on a card (`-m cuda`) and skip without one."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: requires a CUDA device")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


# a reddit-shaped cell cut to run in seconds on the CPU
TINY = {"num_nodes": 1500, "num_edges": 20000, "feat_dim": 48, "num_classes": 7}
