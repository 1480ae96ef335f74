from repro_torch.data.pipeline import (
    PrefetchLoader,
    ZoneDataPipeline,
    ZoneDataStore,
)

__all__ = ["ZoneDataStore", "ZoneDataPipeline", "PrefetchLoader"]
