"""Multi-device sharding layer: meshes of shards, halo exchange, sharded level
ops (PyTorch port of ``multigrid_poisson_solver_tpu/parallel``: the 2-D row
and block policies, and the 3-D z-plane policy of ``pallas_shard3.py``).

Single-controller within a process: a process drives the mesh entries it
owns, which are torch devices and may repeat, so a ring of eight shards can
live on one card (``make_mesh(["cuda:0"] * 8)``) and every shard has its
own buffers and neighbours. Multi-process across processes
(``parallel.multihost``, the counterpart of JAX's multi-host layer): every
``torch.distributed`` rank runs the same program on the same mesh, owns its
entries' blocks, and ``parallel.sharded`` moves halos, partial sums and
gathered levels between the ranks, with the results of one process bit for
bit.
"""
