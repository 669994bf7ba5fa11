"""Row gathers: the three microbenchmark kernels of `bench/`.

Three TPU kernels become the CUDA kernels of `csrc/gather.cu`, each with
the same function in plain PyTorch beside it:

  K6 `kernel` of `bench_pallas_vmem_gather` (`maxk_tpu/bench/micro.py:142`)
      → `slab_gather_cuda`: out[e] = slab[idx[e]], whole rows served from a
        slab held in L2 (the TPU kernel's slab in VMEM), so the slab must
        fit the card's L2;
  K7 `kernel` of `bench_pallas_dma_gather` (`micro.py:204`)
      → `dma_gather_cuda`: out[e] = x[idx[e]] from device memory, 16 rows
        of copies in flight;
  K8 `gk` (`maxk_tpu/bench/probe_topk.py:96`)
      → `take_along_rows_cuda`: out[r, j] = x[r, idx[r, j]].

K6 and K7 compute one function, a row gather (`gather_rows_plain`); K8's
plain version is the CBSR sample's. An index outside the table (or the
row) gives a zero row (element), in kernel and plain version alike; the
kernels never use it as an address. `slab_gather`, `dma_gather` and
`take_along_rows` run the kernel for CUDA tensors and the plain version
for CPU tensors.
"""

from __future__ import annotations

import torch

from maxk_tpu_torch.ops import _native
from maxk_tpu_torch.ops.cbsr_cuda import sample_plain

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the DMA ring's shared-memory budget and rows (csrc/gather.cu)
_MAX_SMEM_BYTES = 227 * 1024
_DMA_RING = 32


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[e] = table[idx[e]], a zero row for an index outside the table."""
    valid = (idx >= 0) & (idx < table.shape[0])
    rows = table.index_select(0, torch.where(valid, idx, 0))
    zero = torch.zeros((), dtype=table.dtype, device=table.device)
    return torch.where(valid[:, None], rows, zero)


# out[r, j] = x[r, idx[r, j]]; 0 for an index outside [0, D)
take_along_rows_plain = sample_plain


def _check_rows(name: str, table: torch.Tensor, idx: torch.Tensor) -> None:
    _native.check(name, table, KERNEL_DTYPES)
    _native.check(name, idx, (torch.int32,), ndim=1)
    if idx.device != table.device:
        raise ValueError(f"{name}: indices on {idx.device}, table on {table.device}")
    if table.shape[0] < 1 or table.shape[1] < 1:
        raise ValueError(f"{name}: empty table {tuple(table.shape)}")


def slab_gather_cuda(slab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K6. The slab must fit the card's L2, which serves its rows. Counts
    its launches in `slab_gather_cuda.launches`."""
    _check_rows("slab_gather", slab, idx)
    s, d = slab.shape
    nbytes = s * d * slab.element_size()
    l2 = _native.l2_cache_bytes()
    if nbytes > l2:
        raise ValueError(
            f"slab_gather: a slab of {nbytes} B is larger than the card's L2 of {l2} B, "
            "which holds the slab"
        )
    n = idx.shape[0]
    out = torch.empty((n, d), dtype=slab.dtype, device=slab.device)
    if n == 0:
        return out
    name = "slab_gather_f32" if slab.dtype == torch.float32 else "slab_gather_bf16"
    _native.launch(name, slab.data_ptr(), idx.data_ptr(), out.data_ptr(), s, d, n)
    slab_gather_cuda.launches += 1
    return out


slab_gather_cuda.launches = 0


def dma_gather_cuda(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K7. Rows move as 16-byte copies: D · itemsize must be a multiple of
    16, and 32 rows must fit in shared memory. Counts its launches in
    `dma_gather_cuda.launches`."""
    _check_rows("dma_gather", x, idx)
    v, d = x.shape
    row_bytes = d * x.element_size()
    if row_bytes % 16 or x.data_ptr() % 16:
        raise ValueError(
            f"dma_gather: rows of {row_bytes} B at address {x.data_ptr():#x} must be "
            "16-byte multiples, 16-byte aligned"
        )
    if _DMA_RING * row_bytes > _MAX_SMEM_BYTES:
        raise ValueError(f"dma_gather: rows of {row_bytes} B do not fit a ring of {_DMA_RING}")
    n = idx.shape[0]
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    _native.launch("dma_gather", x.data_ptr(), idx.data_ptr(), out.data_ptr(), v, row_bytes, n)
    dma_gather_cuda.launches += 1
    return out


dma_gather_cuda.launches = 0


def take_along_rows_cuda(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K8: one thread per (r, j). Counts its launches in
    `take_along_rows_cuda.launches`."""
    _native.check("take_along_rows", x, KERNEL_DTYPES)
    _native.check("take_along_rows", idx, (torch.int32,))
    r, d = x.shape
    if idx.shape[0] != r or idx.device != x.device:
        raise ValueError(
            f"take_along_rows: indices {tuple(idx.shape)} on {idx.device} do not match "
            f"{r} rows on {x.device}"
        )
    k = idx.shape[1]
    out = torch.empty((r, k), dtype=x.dtype, device=x.device)
    if r == 0 or k == 0:
        return out
    name = "take_rows_f32" if x.dtype == torch.float32 else "take_rows_bf16"
    _native.launch(name, x.data_ptr(), idx.data_ptr(), out.data_ptr(), r, k, d)
    take_along_rows_cuda.launches += 1
    return out


take_along_rows_cuda.launches = 0


def _on_cpu(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"{name}: no implementation for device {t.device}")


def slab_gather(slab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if slab.is_cuda:
        return slab_gather_cuda(slab, idx)
    _on_cpu("slab_gather", slab)
    return gather_rows_plain(slab, idx)


def dma_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return dma_gather_cuda(x, idx)
    _on_cpu("dma_gather", x)
    return gather_rows_plain(x, idx)


def take_along_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return take_along_rows_cuda(x, idx)
    _on_cpu("take_along_rows", x)
    return take_along_rows_plain(x, idx)
