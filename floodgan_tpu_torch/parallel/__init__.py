"""The ``(data, spatial)`` mesh across processes (``mesh``), the spatial
axis's halo exchanges and shard-wise layers (``spatial``) and striped
loading (``multihost``): the port of floodgan_tpu/parallel."""
