from repro_torch.data.spatial import SpatialDataset, e3sm_like_field, zipf_query_stream
from repro_torch.data.tokens import synthetic_token_batches

__all__ = ["SpatialDataset", "e3sm_like_field", "synthetic_token_batches", "zipf_query_stream"]
