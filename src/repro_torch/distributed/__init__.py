"""Distributed helpers of the port: gradient compression
(``collectives.py``) and the sharding rules with their DTensor placements
(``sharding.py``); the meshes are in ``launch/mesh.py``."""
