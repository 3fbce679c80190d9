"""Device-mesh parallelism of the PyTorch port (counterpart of
mpskit_tpu/parallel): the mesh and the sharded layouts (`mesh`), the
products split over the mesh's bond axis (`split`), the conversions
between a sharded state and the local tensors that the main loops run on
(`sharded`) and the entry points that gather one (`replicated`).

The names of `mesh` are loaded on first use: `torch.distributed.tensor`
takes seconds to import, and a program that makes no mesh needs none of
it."""

_MESH_NAMES = ("make_mesh", "replicate", "shard_env", "shard_finite_mps",
               "shard_infinite_mps")


def __getattr__(name):
    if name in _MESH_NAMES:
        from . import mesh
        return getattr(mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
