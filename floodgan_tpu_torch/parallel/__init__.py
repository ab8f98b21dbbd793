"""Data parallelism across processes (``mesh``) and striped loading
(``multihost``): the port of floodgan_tpu/parallel's data axis."""
