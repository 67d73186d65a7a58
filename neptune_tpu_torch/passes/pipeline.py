"""The staged lowering pipeline with per-stage IR dumps.

The port of `neptune_tpu/passes/pipeline.py`: the same stages (verify and
annotate, the high-level `time_advance` rewrite, re-verify), ending in this
package's torch `CompiledModule` instead of the JAX executor.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..config import config
from ..ir.core import Module
from ..ir.printer import print_module
from ..ir.verify import verify_and_annotate
from ..lowering.executor import CompiledModule
from .high_level import convert_time_advance

STAGES: tuple[tuple[str, Callable[[Module], Module]], ...] = (
    ("verify-annotate", verify_and_annotate),
    ("high-level-convertion", convert_time_advance),
    # re-verify: the rewrite introduced new applies needing shape annotations
    ("post-convert-verify", verify_and_annotate),
)


class PipelineResult:
    def __init__(self, module: Module, dumps: dict[str, str]):
        self.module = module
        self.dumps = dumps

    def compiled(self, backend: Optional[str] = None, device=None) -> CompiledModule:
        return CompiledModule(self.module, backend, device)


def run_pipeline(
    module: Module,
    *,
    until: Optional[str] = None,
    clone: bool = True,
    collect_dumps: bool = True,
) -> PipelineResult:
    """Run the lowering pipeline, optionally stopping after stage `until`.

    With clone=True the input module is left untouched.
    """
    if until is not None and until not in {name for name, _ in STAGES}:
        raise ValueError(
            f"unknown pipeline stage {until!r}; stages: "
            + ", ".join(name for name, _ in STAGES)
        )
    m = module.clone() if clone else module
    dumps: dict[str, str] = {}
    if collect_dumps:
        dumps["input"] = print_module(m)
    for name, stage in STAGES:
        m = stage(m)
        if collect_dumps:
            dumps[name] = print_module(m)
        if config.dump_ir:
            print(f"// ----- IR after {name} -----")
            print(dumps.get(name) or print_module(m))
        if until == name:
            break
    return PipelineResult(m, dumps)


def compile_ir(
    module: Module, backend: Optional[str] = None, device=None
) -> CompiledModule:
    """One-call lowering: pipeline + executor."""
    return run_pipeline(module).compiled(backend, device)
