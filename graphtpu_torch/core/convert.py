"""State carried over from the JAX package.

Exact SimRank has no weights: its state is the graph and the product plans
built from it.  These constructors take the numpy arrays of ``graphtpu``'s
objects (``host_csr(g)``, and an ``SpmvStream``'s or a ``ReductionTree``'s
fields after ``np.asarray``), so both packages can compute on identical
inputs without this package importing ``graphtpu``.
"""

from graphtpu_torch.core.graph import graph_from_numpy
from graphtpu_torch.kernels.spmm import stream_from_numpy, tree_from_numpy

__all__ = ["graph_from_numpy", "stream_from_numpy", "tree_from_numpy"]
