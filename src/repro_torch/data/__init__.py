from repro_torch.data.pipeline import (  # noqa: F401
    DataPipeline, PipelineState, SyntheticLMSource, MemmapSource,
)
