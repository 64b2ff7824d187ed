from .csr import CSR, csr_from_edges, transpose_csr
from .rmat import rmat_edges, wikipedia_like
from . import apps, oracles

__all__ = ["CSR", "csr_from_edges", "transpose_csr", "rmat_edges",
           "wikipedia_like", "apps", "oracles"]
