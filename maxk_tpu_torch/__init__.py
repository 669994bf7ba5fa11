"""maxk_tpu_torch — the PyTorch and CUDA port of `maxk_tpu`, for NVIDIA Hopper.

The JAX package `maxk_tpu` is the reference; this package mirrors its
layout so each module has a counterpart of the same name:

    maxk_tpu_torch.sparse   CSR and CBSR containers, the operator bundle
    maxk_tpu_torch.ops      SpMM, maxk_spgemm, the MaxK mask, dispatch
    maxk_tpu_torch.models   MaxK-SAGE and the flax parameter importer
    maxk_tpu_torch.train    config, loop, optimizer, metrics, logging
    maxk_tpu_torch.data     dataset registry, synthetic graphs, binary IO
    maxk_tpu_torch/csrc/    hand-written CUDA kernels (built at first use)

It imports torch, numpy and scipy only. Train with
`python -m maxk_tpu_torch --dataset reddit ...`.
"""

__version__ = "0.1.0"
