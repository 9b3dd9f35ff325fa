from repro_torch.data.spatial import SpatialDataset, e3sm_like_field, zipf_query_stream

__all__ = ["SpatialDataset", "e3sm_like_field", "zipf_query_stream"]
