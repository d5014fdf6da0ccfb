"""State carried over from the JAX package.

Exact SimRank has no weights: its state is the graph and the product plans
built from it.  SGNS's state is its two tables.  These constructors take
the numpy arrays of ``graphtpu``'s objects (``host_csr(g)``, an
``SpmvStream``'s or a ``ReductionTree``'s fields after ``np.asarray``, and
``train_sgns``'s ``(syn0, syn1)``), so both packages can compute on
identical inputs without this package importing ``graphtpu``.  A
checkpoint file of graphtpu's ``train_sgns`` resumes in the port as it is
(:mod:`graphtpu_torch.models.checkpoint`).
"""

from graphtpu_torch.core.graph import graph_from_numpy
from graphtpu_torch.kernels.spmm import stream_from_numpy, tree_from_numpy
from graphtpu_torch.models.sgns import params_from_numpy

__all__ = ["graph_from_numpy", "params_from_numpy", "stream_from_numpy", "tree_from_numpy"]
