"""I/O in the reference file formats (counterpart of ``graphtpu/io``).

  * edge lists  — ``src SEP dst [SEP weight]`` text
  * ``.sim.txt`` — per-source top-k similarity lines ``v,n:score,...``
  * ``.emb``     — word2vec text format
  * ``.mat``     — BlogCatalog MAT file with ``network``/``group``
"""

from graphtpu_torch.io.edgelist import read_edgelist, write_edgelist
from graphtpu_torch.io.simfile import read_sim_file, write_sim_file, write_topk_files
from graphtpu_torch.io.embfile import read_emb, write_emb
from graphtpu_torch.io.matfile import load_blogcatalog

__all__ = [
    "read_edgelist",
    "write_edgelist",
    "read_sim_file",
    "write_sim_file",
    "write_topk_files",
    "read_emb",
    "write_emb",
    "load_blogcatalog",
]
