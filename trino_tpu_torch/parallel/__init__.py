"""The device mesh: shards, collectives and the distributed group-by."""

from trino_tpu_torch.parallel.core import WORKER_AXIS, Mesh, make_mesh

__all__ = ["Mesh", "WORKER_AXIS", "make_mesh"]
