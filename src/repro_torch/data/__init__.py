"""The training feed (port of ``repro.data``)."""
from .pipeline import PipelineConfig, ShardedTokenPipeline  # noqa: F401
