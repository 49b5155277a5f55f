"""OME-Zarr stores and synthetic fixtures (``ngff.py`` on the port's own
chunk engine, ``chunkstore.py``, with blosc-zstd decoded in
``native/zarrcodec.c``; imported lazily by the store and CLI layer, never by
the compute path)."""
