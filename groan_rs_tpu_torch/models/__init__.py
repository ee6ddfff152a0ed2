"""Composed analyses."""

from .pipeline import PipelineRunner, TrajectoryAnalysis, run_many

__all__ = ["PipelineRunner", "TrajectoryAnalysis", "run_many"]
