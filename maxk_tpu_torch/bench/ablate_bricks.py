"""Where the brick SpMM kernel (K5) spends its time on the card.

    python -m maxk_tpu_torch.bench.ablate_bricks [--v 32768 --e 1000000 --dim 256]

Builds copies of `csrc/spmm_bricks.cu`, each with one part of the work
taken out by a text edit, into the kernels' build directory, and times
each beside the kernel itself on probe_bricks' default graph, f32 and bf16:

  no_atomics   the Y tile's shared atomic adds become plain adds (racy)
  no_x_loads   the items multiply 1.0 in place of their X row
  no_adds      the items are dropped: the walk of the schedule alone

Only `kernel`'s output is right; the others are timings. Prints one JSON
line: ms by variant and dtype, and the card's name.

The edits name lines of the kernel's source as it stands: a rewrite of the
kernel may leave one without its line, and the tool then raises naming it.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

EDITS = {
    "kernel": [],
    "no_atomics": [("atomicAdd(yr + i * L, a * xv[u][i]);", "yr[i * L] += a * xv[u][i];")],
    "no_x_loads": [("          load4(xr + 4 * j, keep, xv[u]);",
                    "          for (int i = 0; i < 4; ++i) xv[u][i] = 1.0f;")],
    "no_adds": [("          while (tail - head >= G * kUnroll) add_items(G * kUnroll);",
                 "          head = tail;")],
}


def build_variants() -> dict:
    """name -> the loaded library of that copy of the kernel."""
    from maxk_tpu_torch.ops import _native

    src = (_native.CSRC / "spmm_bricks.cu").read_text()
    _native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmds, paths = [], {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"ablate_bricks: edit {name!r} no longer applies to the source")
            text = text.replace(old, new)
        cu = _native.BUILD_DIR / f"ablate_{name}.cu"
        cu.write_text(text)
        paths[name] = _native.BUILD_DIR / f"ablate_{name}.so"
        cmds.append([_native._nvcc(), *_native.NVCC_FLAGS, f"-I{_native.CSRC}", "-shared",
                     "-o", str(paths[name]), str(cu)])
    _native._run_all(cmds)
    return {name: ctypes.CDLL(str(path)) for name, path in paths.items()}


def main(argv=None) -> dict:
    from maxk_tpu_torch.bench.micro import rand, timeit
    from maxk_tpu_torch.data.synthetic import rmat_graph
    from maxk_tpu_torch.ops import _native
    from maxk_tpu_torch.sparse.bricks import build_bricks

    p = argparse.ArgumentParser()
    p.add_argument("--v", type=int, default=32768)
    p.add_argument("--e", type=int, default=1_000_000)
    p.add_argument("--dim", type=int, default=256)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ablate_bricks: no CUDA device; the kernels run only on the card")
    libs = build_variants()
    sched = build_bricks(rmat_graph(args.v, args.e, seed=123)).to("cuda")
    v = sched.num_nodes
    out = {"device": torch.cuda.get_device_name(0)}
    for dtype in ("float32", "bfloat16"):
        x = rand((v, args.dim), getattr(torch, dtype), device="cuda")
        y = torch.empty_like(x)
        name = "spmm_bricks_f32" if dtype == "float32" else "spmm_bricks_bf16"
        for variant, lib in libs.items():
            fn = getattr(lib, name)
            fn.argtypes = _native.SIGNATURES[name]
            fn.restype = ctypes.c_int

            def call(fn=fn):
                err = fn(sched.chunk_panel.data_ptr(), sched.chunk_sgroup.data_ptr(),
                         sched.meta.data_ptr(), sched.idx.data_ptr(), sched.val.data_ptr(),
                         x.data_ptr(), y.data_ptr(), sched.num_chunks, sched.ch, sched.slots,
                         sched.num_sgroups, sched.sg, sched.panel, sched.wb, sched.win, v, v,
                         args.dim, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"ablate_bricks {variant}: CUDA error {err}")
                return y

            out[f"{variant}_{dtype}_ms"] = 1e3 * timeit(call, iters=20)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
