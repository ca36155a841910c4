from .pipeline import DataConfig, Prefetcher, synthetic_batch  # noqa: F401
