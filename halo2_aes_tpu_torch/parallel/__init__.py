"""Multi-device proving over ``torch.distributed`` (port of ``parallel/``).

``comm`` holds the mesh (one process per rank) and its collectives,
``ntt`` the distributed four-step transform, ``msm`` the point-sharded
MSM, ``dryrun`` the multi-rank dry run and the rank entry point.
"""
