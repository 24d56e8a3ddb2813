"""Multi-device encoding over ``torch.distributed`` (the port of
``tiler_tpu/parallel``): meshes, their collectives, the corpus-sharded
top-k and k-means."""
from .kmeans import sharded_lloyd_step  # noqa: F401
from .knn import sharded_topk  # noqa: F401
from .mesh import make_mesh  # noqa: F401
