"""Build and load the generated CUDA kernels.

Each generated source is a small `.cu` file that includes the fixed device
code under `neptune_tpu_torch/csrc/` and exposes a plain C interface. It is
compiled by `nvcc` into a shared library and loaded with `ctypes`; device
pointers and the stream go across as `c_void_p`, and every C entry returns
the CUDA status of its launch, which the caller turns into an exception.

Libraries land in `neptune_tpu_torch/_build/`, or in `kernels/` under
`config.cache_dir` when that is set (read at each build), keyed by a hash
of the generated source, the headers and the flags, so a checkout builds
what it needs at first use. Nothing here runs when the module is imported.

`--fmad=false` keeps every f32 multiply and add separately rounded, so an f32
kernel is bitwise equal to the eager PyTorch version of the same IR.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from ..config import config
from ..utils.profiling import OFF, span

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)


class LaunchCounter:
    """Counts the launches of one kernel: its wrapper runs each launch, from
    its argument checks to the return of the C call, inside `launch()`,
    which adds one when the block ends without an exception and, while a
    profiler runs, is the span `nt.launch.<name>` (`utils.profiling`)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.span_name = f"nt.launch.{name}"

    def reset(self) -> None:
        self.count = 0

    def launch(self):
        """The boundary of one launch, as a context manager: the counter
        itself, or while a profiler runs its span, which closes the counter
        with it."""
        s = span(self.span_name)
        if s is OFF:
            return self
        s.counter = self
        return s

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.count += 1
        return False


def check(status: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from source at first use "
        "(put the CUDA toolkit's bin/ on PATH or set CUDA_HOME)"
    )


def kernel_dir() -> Path:
    """Where the kernels' libraries go: `config.cache_dir`/kernels when the
    setting is given, the package's `_build/` otherwise."""
    return Path(config.cache_dir) / "kernels" if config.cache_dir else BUILD_DIR


def _headers_digest() -> bytes:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.digest()


class Builder:
    """Compiles generated sources once per process and per checkout, into
`build_dir`, or `kernel_dir()` at each build when that is None."""

    def __init__(self, build_dir: Path | None = None):
        self._build_dir = None if build_dir is None else Path(build_dir)
        self._libs: dict[str, ctypes.CDLL] = {}
        # library file name -> nvcc seconds, for libraries built by this process
        self.build_seconds: dict[str, float] = {}

    @property
    def build_dir(self) -> Path:
        return self._build_dir or kernel_dir()

    def load(self, source: str, stem: str) -> ctypes.CDLL:
        key = hashlib.sha256(
            source.encode() + _headers_digest() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:20]
        if key in self._libs:
            return self._libs[key]
        so = self.build_dir / f"{stem}_{key}.so"
        if not so.exists():
            self._compile(source, so)
        lib = ctypes.CDLL(str(so))
        self._libs[key] = lib
        return lib

    def _compile(self, source: str, so: Path) -> None:
        nvcc = nvcc_path()
        so.parent.mkdir(parents=True, exist_ok=True)
        cu = so.with_suffix(".cu")
        cu.write_text(source)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(cu)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {cu}:\n{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        self.build_seconds[so.name] = time.perf_counter() - t0


builder = Builder()
