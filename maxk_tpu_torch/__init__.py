"""maxk_tpu_torch — the PyTorch and CUDA port of `maxk_tpu`, for NVIDIA Hopper.

The JAX package `maxk_tpu` is the reference; this package mirrors its
layout so each module has a counterpart of the same name:

    maxk_tpu_torch.sparse   CSR and CBSR containers, the operator bundle,
                            brick schedules
    maxk_tpu_torch.ops      SpMM, maxk_spgemm, the MaxK mask, dispatch,
                            the brick SpMM and the row gathers
    maxk_tpu_torch.models   MaxK-SAGE/GCN/GIN, their ReLU arms, GNNRes and
                            the flax parameter importer
    maxk_tpu_torch.train    config, loop, optimizer, metrics (ROC-AUC
                            too), logging, the golden accuracy floors
    maxk_tpu_torch.data     dataset registry, R-MAT and DC-SBM graphs,
                            ogbn-proteins' edge features, binary IO and
                            the export / check CLIs
    maxk_tpu_torch.parallel the row-partitioned multi-device path
    maxk_tpu_torch.bench    benchmark entry points (`python -m maxk_tpu_torch.bench`)
    maxk_tpu_torch/csrc/    hand-written CUDA kernels (built at first use)

It imports torch, numpy and scipy only. Train with
`python -m maxk_tpu_torch --dataset reddit ...`.
"""

__version__ = "0.1.0"
