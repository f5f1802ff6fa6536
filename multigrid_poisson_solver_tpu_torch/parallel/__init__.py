"""Multi-device sharding layer: meshes of shards, halo exchange, sharded level
ops (PyTorch port of ``multigrid_poisson_solver_tpu/parallel``: the 2-D row
and block policies, and the 3-D z-plane policy of ``pallas_shard3.py``).

Single-controller, as the JAX package: one process drives a mesh whose
entries are torch devices and may repeat, so a ring of eight shards can live
on one card (``make_mesh(["cuda:0"] * 8)``) and every shard has its own
buffers and neighbours.
"""
