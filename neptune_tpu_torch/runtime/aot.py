"""Native AOT compilation + loading.

The port of `neptune_tpu/runtime/aot.py`. Mirrors the reference's AOT cache
pipeline (`python_frontend/neptune/backend.py:11-93`): hash the generated
source → probe `~/.neptune_tpu_torch/cache/` → compile with the system C++
compiler → link against the runtime library with an rpath → load via
ctypes — with the same 7-day atime-based eviction policy
(`backend.py:77-87`). Cache dir override: `config.cache_dir`
(NEPTUNE_TORCH_CACHE_DIR), which also routes the CUDA kernels' builds.

The native runtime is the f64 host oracle by design: it is the one entry
point of this package that runs on the CPU without being asked. Its
functions take NumPy arrays or tensors on any device, copy them to host
f64 buffers (the generated code writes into field arguments, so the
caller's data is never handed over), and return CPU f64 tensors.

Several processes may build one hash at once (parallel test workers): each
library and source goes to a temporary name in the cache and is renamed
into place, so a loader sees all of a file or none of it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..config import config
from ..ir.core import Module
from ..ir.types import FieldType, ScalarType, TempType, TensorType
from .cgen import generate_cpp

_RUNTIME_SRC = Path(__file__).parent / "native" / "neptune_rt.cpp"


def _cache_dir() -> Path:
    """`config.cache_dir` (NEPTUNE_TORCH_CACHE_DIR), read at each build, or
    `~/.neptune_tpu_torch/cache`."""
    if config.cache_dir:
        d = Path(config.cache_dir)
    else:
        d = Path.home() / ".neptune_tpu_torch" / "cache"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _cleanup_old_cache(d: Path, max_age_days: int = 7):
    """7-day atime eviction (reference backend.py:77-87)."""
    try:
        now = time.time()
        cutoff = max_age_days * 24 * 3600
        for p in d.glob("neptune_*"):
            if now - p.stat().st_atime > cutoff:
                p.unlink()
    except OSError:
        pass


_CXX = os.environ.get("CXX", "g++")
_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17"]


@functools.lru_cache(maxsize=None)
def _openmp() -> tuple:
    """("-fopenmp",) where the compiler links OpenMP, () where it cannot
    (a g++ without libgomp). The generated loop nests parallelise only
    loops whose iterations write disjoint cells, so the results are the
    same either way."""
    with tempfile.TemporaryDirectory() as d:
        src = Path(d, "probe.cpp")
        src.write_text("int neptune_probe() { return 0; }\n")
        cmd = [_CXX, "-fopenmp", "-fPIC", "-shared", "-o", str(Path(d, "probe.so")), str(src)]
        ok = subprocess.run(cmd, capture_output=True).returncode == 0
    return ("-fopenmp",) if ok else ()


def _write_atomic(path: Path, text: str) -> None:
    fd, tmp = tempfile.mkstemp(suffix=path.suffix, dir=path.parent)
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _compile(src_path: Path, out_path: Path, extra: tuple = ()):
    """Build out_path from src_path under a temporary name, then rename it
    into place."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_path.parent)
    os.close(fd)
    cmd = [_CXX, *_CXXFLAGS, *_openmp(), "-shared", "-o", tmp, str(src_path), *extra]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native compile failed:\n{r.stderr[:4000]}")
    os.replace(tmp, out_path)


def runtime_library() -> Path:
    """Build (or fetch from cache) libneptune_rt.so."""
    d = _cache_dir()
    src = _RUNTIME_SRC.read_text()
    h = hashlib.sha256(src.encode()).hexdigest()[:16]
    so = d / f"neptune_rt_{h}.so"
    if not so.exists():
        _compile(_RUNTIME_SRC, so)
    else:
        so.touch()  # keep the eviction policy from deleting a lib that
        # cached kernels still reference by absolute path
    return so


def _host_f64(a) -> np.ndarray:
    """A fresh C-ordered f64 host copy of an array or a tensor on any
    device."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float64).numpy()
    return np.array(a, dtype=np.float64, order="C", copy=True)


class NativeCompiledModule:
    """ctypes-backed executable view of a lowered module (the reference's
    `ctypes.CDLL` result, backend.py:74-75, with a host-f64 wrapper)."""

    def __init__(self, module: Module, keep_source: bool = False):
        self.module = module
        d = _cache_dir()
        _cleanup_old_cache(d)
        src = generate_cpp(module)
        self.source = src if keep_source else None
        h = hashlib.sha256(src.encode()).hexdigest()[:16]
        so = d / f"neptune_kernel_{h}.so"
        # always resolve the runtime library: a cached kernel links to it by
        # absolute path, so it must exist (and stay atime-fresh) even on the
        # cache-hit path
        rt = runtime_library()
        if not so.exists():
            src_path = d / f"neptune_kernel_{h}.cpp"
            _write_atomic(src_path, src)
            _compile(src_path, so, extra=(str(rt), f"-Wl,-rpath,{d}"))
        else:
            so.touch()  # refresh atime for the eviction policy
        self._lib = ctypes.CDLL(str(so))
        self._fns: dict = {}

    def function(self, name: str):
        if name in self._fns:
            return self._fns[name]
        irfn = self.module.lookup(name)
        if irfn.kind != "func":
            raise KeyError(f"@{name} is not an exported function")
        cfn = getattr(self._lib, f"nt_{name}")
        cfn.restype = None
        cfn.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p),
        ]
        arg_types = [a.type for a in irfn.body.args]
        term = irfn.body.terminator
        out_types = [o.type for o in term.operands] if term else []

        def run(*args):
            if len(args) != len(arg_types):
                raise TypeError(
                    f"@{name} expects {len(arg_types)} args, got {len(args)}"
                )
            holders = []  # keep ndarray refs alive through the call
            in_ptrs = (ctypes.c_void_p * max(len(args), 1))()
            for i, (a, t) in enumerate(zip(args, arg_types)):
                if isinstance(t, (TempType, FieldType, TensorType)):
                    # always copy: field args are mutable buffers in the
                    # generated code; caller arrays must stay untouched
                    arr = _host_f64(a)
                    want = t.bounds.shape if hasattr(t, "bounds") else t.shape
                    if arr.shape != tuple(want):
                        raise TypeError(
                            f"@{name} arg {i}: shape {arr.shape} != {tuple(want)}"
                        )
                elif isinstance(t, ScalarType):
                    arr = np.asarray([float(a)], dtype=np.float64)
                else:
                    raise TypeError(f"unsupported arg type {t}")
                holders.append(arr)
                in_ptrs[i] = arr.ctypes.data_as(ctypes.c_void_p)
            outs = []
            out_ptrs = (ctypes.c_void_p * max(len(out_types), 1))()
            for j, t in enumerate(out_types):
                # grid-typed results (temp OR field — cgen memcpys the full
                # extent for both) get full-shape buffers; a (1,) buffer for
                # a field result would be overflowed by the memcpy
                if isinstance(t, TensorType):
                    shape = t.shape
                elif hasattr(t, "bounds"):  # TempType / FieldType
                    shape = t.bounds.shape
                else:
                    shape = (1,)
                o = np.empty(shape, dtype=np.float64)
                outs.append(o)
                out_ptrs[j] = o.ctypes.data_as(ctypes.c_void_p)
            cfn(in_ptrs, out_ptrs)
            if not out_types:
                return None
            res = [
                torch.from_numpy(o) if not isinstance(t, ScalarType) else float(o[0])
                for o, t in zip(outs, out_types)
            ]
            return res[0] if len(res) == 1 else tuple(res)

        run.__name__ = f"native_{name}"
        self._fns[name] = run
        return run


def compile_native(module: Module, **kw) -> NativeCompiledModule:
    """Lower (this package's pipeline) + compile a module for the native
    host runtime."""
    from ..passes import run_pipeline

    pr = run_pipeline(module, collect_dumps=False)
    return NativeCompiledModule(pr.module, **kw)
