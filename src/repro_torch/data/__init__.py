"""Data substrate: synthetic corpora, workloads, block store, pipeline."""

from repro_torch.data.datagen import (  # noqa: F401
    make_errorlog_ext,
    make_errorlog_int,
    make_tpch_like,
)
from repro_torch.data.workload import (  # noqa: F401
    make_errorlog_ext_workload,
    make_errorlog_int_workload,
    make_tpch_workload,
)
from repro_torch.data.blocks import BlockStore, ScanResult  # noqa: F401
from repro_torch.data.pipeline import (  # noqa: F401
    ElasticBlockScheduler,
    PipelineConfig,
    QdTreePipeline,
    records_to_tokens,
)
