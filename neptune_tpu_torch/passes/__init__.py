"""IR-to-IR passes and the staged lowering pipeline."""

from .high_level import convert_time_advance
from .pipeline import PipelineResult, compile_ir, run_pipeline

__all__ = ["convert_time_advance", "PipelineResult", "compile_ir", "run_pipeline"]
