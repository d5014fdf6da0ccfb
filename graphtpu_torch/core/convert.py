"""State carried over from the JAX package.

Exact SimRank has no weights: its state is the graph and the product plans
built from it.  SGNS's state is its two tables; DeepSim's is (W1, b1, W2,
b2) and SDNE's a list of (w, b) layers.  These constructors take the numpy
arrays of ``graphtpu``'s objects (``host_csr(g)``, an ``SpmvStream``'s or a
``ReductionTree``'s fields after ``np.asarray``, ``train_sgns``'s
``(syn0, syn1)`` and the models' ``init_params`` or trained parameters),
so both packages can compute on identical inputs without this package
importing ``graphtpu``.  A checkpoint file of graphtpu's ``train_sgns``
resumes in the port as it is (:mod:`graphtpu_torch.models.checkpoint`).
"""

from graphtpu_torch.core.graph import graph_from_numpy
from graphtpu_torch.kernels.spmm import stream_from_numpy, tree_from_numpy
from graphtpu_torch.models.deepsim import params_from_numpy as deepsim_params_from_numpy
from graphtpu_torch.models.sdne import params_from_numpy as sdne_params_from_numpy
from graphtpu_torch.models.sgns import params_from_numpy

__all__ = ["deepsim_params_from_numpy", "graph_from_numpy", "params_from_numpy",
           "sdne_params_from_numpy", "stream_from_numpy", "tree_from_numpy"]
