#!/usr/bin/env python3
"""Time kernels A, C and D of this checkout under candidate tiles, on a GPU.

    python3 scripts/torch_tile_times.py [--kernels ACD]

For chip_smoke.py's main kernel-A, kernel-C and kernel-D cases, builds
each kernel under every candidate tile below (`cuda_backend.apply_plan(op,
tiles)`, `sweeps.sweep_plan(..., depth, tiles)`, `chain.chain_plan(...,
tiles=)`), checks it bitwise against its plain version, and times it with
CUDA events, the candidates in turns (first, ..., last, last, ..., first).
One JSON line per case and candidate: the data behind the plans' tile lists
(`cuda_backend.APPLY_TILES`, `sweeps.TILES`, `chain.TILES`) and kernel C's
recompute cap (`sweeps.MAX_RECOMPUTE`). `--kernels AD` times a subset.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# kernel A: (rows, columns, cells per thread, planes)
A_TILES = {
    2: [(32, 64, 8, 1), (16, 128, 8, 1), (32, 128, 16, 1), (16, 64, 4, 1)],
    3: [(16, 64, 4, 4), (8, 64, 2, 8), (16, 64, 4, 2), (32, 64, 8, 4), (16, 64, 4, 8)],
}
# kernel C: depth -> (columns per lane, planes, rows, rows per strip, planes per task)
C_TILES = {
    2: {16: [(4, 1, 64, 8, 1)], 8: [(4, 1, 64, 8, 1)]},
    3: {2: [(1, 16, 16, 4, 8), (1, 16, 16, 4, 4), (2, 8, 8, 4, 4), (1, 32, 8, 4, 8),
            (1, 8, 16, 4, 8), (2, 8, 16, 4, 8), (2, 16, 8, 4, 8), (1, 32, 16, 4, 16)],
        4: [(1, 16, 16, 4, 8), (2, 8, 8, 4, 4), (1, 32, 8, 4, 8), (2, 8, 16, 4, 8)],
        8: [(1, 32, 8, 4, 16), (2, 16, 8, 4, 8)]},
}

# kernel D: chain.ChainTile fields (tile, threads per block, tiles in flight
# beyond the current one (0: one tile per block), blocks per SM to leave
# registers for, longest strip)
D_TILES = {
    2: [((32, 64), 128, 1, 5, 8), ((32, 64), 256, 1, 3, 8), ((64, 64), 256, 1, 2, 8),
        ((32, 64), 128, 1, 5, 6), ((32, 64), 128, 2, 4, 8), ((32, 64), 256, 0, 3, 8),
        ((64, 64), 512, 1, 1, 12)],
    3: [((8, 16, 32), 256, 0, 2, 8), ((8, 8, 32), 256, 0, 2, 8), ((4, 16, 32), 256, 1, 2, 8),
        ((8, 16, 32), 256, 1, 1, 8)],
}


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def turns(cs, calls, reps):
    """Mean ms of each call, timed first..last then last..first."""
    order = list(range(len(calls)))
    ms = [0.0] * len(calls)
    for i in order + order[::-1]:
        ms[i] += cs.cuda_ms(calls[i], reps) / 2
    return ms


def ptxas(source: str) -> dict:
    """Registers per thread and spill bytes of a generated source's kernel,
    as `nvcc -Xptxas -v` reports them (the build's own flags)."""
    from neptune_tpu_torch.kernels.build import CSRC, NVCC_FLAGS, nvcc_path

    with tempfile.TemporaryDirectory() as tmp:
        cu = Path(tmp, "k.cu")
        cu.write_text(source)
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
                               "-o", str(Path(tmp, "k.so")), str(cu)],
                              capture_output=True, text=True, check=True)
    regs = re.search(r"Used (\d+) registers", proc.stderr)
    spill = re.search(r"(\d+) bytes spill stores", proc.stderr)
    return {"regs": int(regs.group(1)) if regs else None,
            "spill_stores": int(spill.group(1)) if spill else None}


def times_d(cs, dev, rng, card):
    import torch

    from neptune_tpu_torch.kernels import codegen
    from neptune_tpu_torch.kernels.build import builder
    from neptune_tpu_torch.lowering import chain

    cases = []
    for label, module, name, n_fields, sc in cs.d_cases():
        if label.startswith("composite 1024"):
            continue
        rank = module.lookup(name).ftype.inputs[0].bounds.rank
        plans = [p for p in (chain.chain_plan(module, name, tiles=(chain.ChainTile(*t),))
                             for t in D_TILES[rank]) if p]
        cases.append((label, n_fields, sc, plans))
    sources = {id(p): codegen.chain_source(p) for *_, plans in cases for p in plans}
    with ThreadPoolExecutor(max_workers=8) as pool:
        builds = [pool.submit(builder.load, s, "stencil_chain") for s in sources.values()]
        infos = {k: pool.submit(ptxas, s) for k, s in sources.items()}
        for j in builds:
            j.result()
        regs = {k: j.result() for k, j in infos.items()}
    for label, n_fields, sc, plans in cases:
        fields = [cs.rand(rng, plans[0].shape, dev) for _ in range(n_fields)]
        sv = [torch.tensor(v, dtype=torch.float32) for v in sc]
        ref = chain.chain_plain(plans[0], fields, sv)
        calls = []
        for p in plans:
            assert torch.equal(chain.run_chain(p, fields, sv), ref), (label, p.tile)
            calls.append(lambda p=p: chain.run_chain(p, fields, sv))
        for p, ms in zip(plans, turns(cs, calls, 20)):
            print(json.dumps({"kernel": "D", "case": label, "card": card, "tile": p.tile,
                              "threads": p.threads, "ahead": p.ahead,
                              "min_blocks": p.min_blocks, "strips": p.strips,
                              "blocks_per_sm": chain.blocks_per_sm(p), "smem": p.smem_bytes,
                              **regs[id(p)], "ms": ms}), flush=True)


def main() -> int:
    args = sys.argv[1:]
    kernels = args[1].upper() if len(args) > 1 and args[0] == "--kernels" else "ACD"
    cs = smoke()
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    from neptune_tpu_torch import stencils
    from neptune_tpu_torch.kernels.build import builder
    from neptune_tpu_torch.lowering import cuda_backend, sweeps, torch_backend

    if not torch.cuda.is_available():
        raise SystemExit("torch_tile_times: no CUDA device")
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    rng = np.random.default_rng(cs.SEED)
    a_cases = [
        ("jacobi5 4096^2 f32", stencils.jacobi5((4096, 4096))),
        ("jacobi5 4096^2 bf16", stencils.jacobi5((4096, 4096), "bfloat16")),
        ("adv4 4096^2 f32", stencils.advection4((4096, 4096))),
        ("heat7 256^3 f32", stencils.heat7((256, 256, 256))),
        ("heat7 256^3 bf16", stencils.heat7((256, 256, 256), "bfloat16")),
    ]
    c_cases = [
        ("jacobi5 4096^2 K=16", stencils.jacobi5((4096, 4096)), "jacobi", 16),
        ("heat7 256^3 K=8", stencils.heat7((256, 256, 256)), "heat", 8),
    ]
    a_plans, c_plans = [], []
    for label, module in a_cases:
        op = stencils.the_apply(module)
        rank = op.results[0].type.bounds.rank
        plans = [p for p in (cuda_backend.apply_plan(op, (t,)) for t in A_TILES[rank]) if p]
        a_plans.append((label, op, plans))
    for label, module, name, k in c_cases:
        rank = len(module.lookup(name).ftype.inputs[0].bounds.shape)
        plans = []
        for depth, tiles in C_TILES[rank].items():
            plans += [p for p in (sweeps.sweep_plan(module, name, k, depth, (t,)) for t in tiles)
                      if p]
        c_plans.append((label, k, plans))
    if "D" in kernels:
        times_d(cs, dev, rng, card)
    a_plans = a_plans if "A" in kernels else []
    c_plans = c_plans if "C" in kernels else []
    with ThreadPoolExecutor(max_workers=8) as pool:
        jobs = [pool.submit(builder.load, cuda_backend.source(op, p), "stencil_apply")
                for _, op, plans in a_plans for p in plans]
        jobs += [pool.submit(builder.load, sweeps.source(p), "stencil_sweeps")
                 for _, _, plans in c_plans for p in plans]
        for j in jobs:
            j.result()
    for label, op, plans in a_plans:
        tt = op.results[0].type
        dtype = torch_backend.DTYPES[tt.element]
        x = torch.from_numpy(rng.standard_normal(tt.bounds.shape, dtype=np.float32)).to(dev, dtype)
        ref = torch_backend.execute_apply(op, [x])
        calls = []
        for p in plans:
            got = cuda_backend.stencil_apply(op, [x], [], dev, plan=p)
            if dtype == torch.float32:
                assert torch.equal(got, ref), (label, p)
            calls.append(lambda p=p: cuda_backend.stencil_apply(op, [x], [], dev, plan=p))
        for p, ms in zip(plans, turns(cs, calls, 20)):
            print(json.dumps({"kernel": "A", "case": label, "card": card, "tile": p.tile,
                              "strip": p.strip, "planes": p.planes,
                              "threads": p.threads, "smem": p.smem_bytes, "ms": ms}), flush=True)
    for label, k, plans in c_plans:
        op = plans[0].op
        x = torch.from_numpy(rng.standard_normal(op.results[0].type.bounds.shape,
                                                 dtype=np.float32)).to(dev)
        calls = []
        for p in plans:
            ref = x
            for _ in range(p.depth):
                ref = cuda_backend.stencil_apply(op, [ref], [], dev)
            assert torch.equal(sweeps.run_sweeps(p, x, []), ref), (label, p)
            calls.append(lambda p=p: sweeps.run_sweeps(p, x, []))
        reps = 3 if x.numel() > 3e7 else 10
        for p, ms in zip(plans, turns(cs, calls, reps)):
            print(json.dumps({"kernel": "C", "case": label, "card": card, "depth": p.depth,
                              "tile": p.tile, "cols": p.cols, "strip": p.strip, "run": p.run,
                              "warps": p.warps, "smem": p.smem_bytes,
                              "recompute": p.recompute, "ms": ms,
                              "us_per_sweep": ms * 1e3 / p.depth}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
