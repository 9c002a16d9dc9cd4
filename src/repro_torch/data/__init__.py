"""Data pipeline (the counterpart of ``repro.data``)."""

from .pipeline import DataConfig, TokenPipeline, synthetic_corpus, zipf_tokens

__all__ = ["DataConfig", "TokenPipeline", "synthetic_corpus", "zipf_tokens"]
