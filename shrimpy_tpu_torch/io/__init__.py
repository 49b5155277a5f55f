"""OME-Zarr stores and synthetic fixtures (tensorstore; imported lazily by
the store and CLI layer, never by the compute path)."""
