"""Input loaders: MatrixMarket files and CSR views."""

from sparsex_jax.io.mmf import MMF, load_mmf
from sparsex_jax.io.csr import CSR

__all__ = ["MMF", "load_mmf", "CSR"]
